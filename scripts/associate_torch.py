#!/usr/bin/env python
"""Associate two TUM-format timestamp files with the PyTorch port
(``rtgslam_torch``; the twin of ``scripts/associate.py``, same CLI and
output).

    python scripts/associate_torch.py rgb.txt depth.txt [--offset 0] [--max_difference 0.02]

Prints matched lines side by side.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtgslam_torch.utils.traj import associate_timestamps


def read_file_list(path):
    entries = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            entries.append((float(parts[0]), parts[1:]))
    return entries


def main():
    p = argparse.ArgumentParser()
    p.add_argument("first_file")
    p.add_argument("second_file")
    p.add_argument("--first_only", action="store_true")
    p.add_argument("--offset", type=float, default=0.0)
    p.add_argument("--max_difference", type=float, default=0.02)
    a = p.parse_args()

    first = read_file_list(a.first_file)
    second = read_file_list(a.second_file)
    matches = associate_timestamps(
        [t for t, _ in first], [t for t, _ in second], a.offset, a.max_difference)
    for i, j in matches:
        ta, da = first[i]
        tb, db = second[j]
        if a.first_only:
            print(f"{ta} {' '.join(da)}")
        else:
            print(f"{ta} {' '.join(da)} {tb - a.offset} {' '.join(db)}")


if __name__ == "__main__":
    main()
