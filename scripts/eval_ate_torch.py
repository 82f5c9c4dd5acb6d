#!/usr/bin/env python
"""Standalone TUM-format ATE evaluation with the PyTorch port
(``rtgslam_torch``; the twin of ``scripts/eval_ate.py``, same CLI and
output).

    python scripts/eval_ate_torch.py groundtruth.txt estimated.txt [--plot out.png]

Both files are TUM trajectories: ``stamp tx ty tz qx qy qz qw`` per line.
Reports Horn-aligned translational RMSE plus mean/median/std in metres.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtgslam_torch.utils.traj import associate_timestamps, horn_align


def read_tum(path):
    rows = np.loadtxt(path, comments="#")
    return rows[:, 0], rows[:, 1:4]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("groundtruth")
    p.add_argument("estimate")
    p.add_argument("--offset", type=float, default=0.0)
    p.add_argument("--max_difference", type=float, default=0.02)
    p.add_argument("--plot", type=str, default="")
    a = p.parse_args()

    gt_t, gt_xyz = read_tum(a.groundtruth)
    es_t, es_xyz = read_tum(a.estimate)
    matches = associate_timestamps(list(gt_t), list(es_t), a.offset, a.max_difference)
    if len(matches) < 2:
        sys.exit("Couldn't find matching timestamp pairs!")
    gt_m = np.stack([gt_xyz[i] for i, _ in matches], axis=1)
    es_m = np.stack([es_xyz[j] for _, j in matches], axis=1)
    _, _, err = horn_align(es_m, gt_m)

    print(f"compared_pose_pairs {len(matches)} pairs")
    print(f"absolute_translational_error.rmse {np.sqrt(np.mean(err**2)):.6f} m")
    print(f"absolute_translational_error.mean {err.mean():.6f} m")
    print(f"absolute_translational_error.median {np.median(err):.6f} m")
    print(f"absolute_translational_error.std {err.std():.6f} m")
    print(f"absolute_translational_error.min {err.min():.6f} m")
    print(f"absolute_translational_error.max {err.max():.6f} m")

    if a.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(gt_m[0], gt_m[1], label="ground truth")
        plt.plot(es_m[0], es_m[1], label="estimated")
        plt.legend()
        plt.savefig(a.plot)


if __name__ == "__main__":
    main()
