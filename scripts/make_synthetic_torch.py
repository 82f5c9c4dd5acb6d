#!/usr/bin/env python
"""Generate a synthetic RGBD scene in the "ours" directory layout with the
PyTorch port (``rtgslam_torch``; the twin of ``scripts/make_synthetic.py``,
same CLI, same files):

    python scripts/make_synthetic_torch.py --out data/synthetic/room --frames 12 --height 170 --width 300
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtgslam_torch.data.synthetic import write_scene

if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="data/synthetic/room")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    a = p.parse_args()
    write_scene(a.out, a.frames, a.height, a.width)
    print(f"wrote {a.frames} frames to {a.out}")
