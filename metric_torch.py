#!/usr/bin/env python
"""Offline evaluation of the PyTorch port (``rtgslam_torch``), the twin of
``metric.py``: loads a saved PLY checkpoint into a fresh mapper, re-renders
every train camera at its estimated pose (``save_traj/pose_es.npy``) at
``renderer_opaque_threshold_eval``, scores PSNR / SSIM / depth L1 per frame
(geometry metrics on the last frame when a GT mesh exists) and writes
``statis_frame_{F}_iter_{I}.csv`` with a ``mean`` row.

    python metric_torch.py --config configs/synthetic/room.yaml [--frame_id -1] [--device cuda|cpu]

The device is CUDA unless ``--device cpu`` asks for the CPU; with no GPU
and no such flag the run stops.  Run from the repository root.
"""

import csv
import glob
import os
import re
import sys
import time
from argparse import ArgumentParser

import numpy as np


def parse_args(argv=None):
    parser = ArgumentParser(description="RTG-SLAM offline eval, PyTorch + CUDA")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--frame_id", type=int, default=-1,
                        help="which save_model/frame_XXXX snapshot (-1 = latest)")
    parser.add_argument("--load_type", type=str, default="merge",
                        choices=["merge", "stable", "unstable"])
    parser.add_argument("--eval_frame_num", type=int, default=-1)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    return parser.parse_args(argv)


def pick_model(save_path: str, frame_id: int, load_type: str):
    """Pick the checkpoint PLY like the reference ``filter_models``
    (metric.py:37-153): (path, frame number, iteration number)."""
    frames = sorted(glob.glob(os.path.join(save_path, "save_model", "frame_*")))
    if not frames:
        raise FileNotFoundError(f"no checkpoints under {save_path}/save_model")
    frame_dir = frames[frame_id]
    frame_num = int(re.search(r"frame_(\d+)", frame_dir).group(1))
    suffix = {"merge": "_merge.ply", "stable": "_stable.ply", "unstable": ".ply"}[load_type]
    plys = sorted(glob.glob(os.path.join(frame_dir, f"iter_*{suffix}")))
    if not plys and load_type == "merge":
        # single-pool runs produce no merge file; fall back to stable
        plys = sorted(glob.glob(os.path.join(frame_dir, "iter_*_stable.ply")))
    if not plys:
        plys = sorted(p for p in glob.glob(os.path.join(frame_dir, "iter_*.ply"))
                      if "sibr" not in p and "stable" not in p and "merge" not in p)
    ply = plys[-1]
    iter_num = int(re.search(r"iter_(\d+)", ply).group(1))
    return ply, frame_num, iter_num


def write_statis_csv(path: str, rows):
    """The per-frame rows and a ``mean`` row, columns in order of first
    appearance (the layout of the pandas frame ``metric.py`` writes); the
    mean of each numeric column skips the rows that lack it.  Returns the
    mean row."""
    columns = []
    for row in rows:
        columns += [k for k in row if k not in columns]
    mean = {}
    for k in columns:
        vals = [r[k] for r in rows if isinstance(r.get(k), (int, float))]
        if vals:
            mean[k] = float(np.mean(vals))
    mean["frame"] = "mean"
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=columns)
        writer.writeheader()
        writer.writerows(rows)
        writer.writerow(mean)
    return mean


def main(argv=None):
    """Evaluate the checkpoint; returns the CSV path, the per-frame rows,
    the mean row and each frame's milliseconds (load, render, score)."""
    cli = parse_args(argv)
    from rtgslam_torch.config import read_config
    from rtgslam_torch.utils.general import require_device, safe_state

    device = require_device(cli.device)
    args = read_config(cli.config)
    stdout = sys.stdout
    safe_state(getattr(args, "quiet", False))
    try:
        return _run(cli, args, device)
    finally:
        sys.stdout = stdout


def _run(cli, args, device):
    from rtgslam_torch.config import DatasetParams
    from rtgslam_torch.data.camera import load_camera
    from rtgslam_torch.data.dataset import Dataset
    from rtgslam_torch.slam.eval import eval_frame
    from rtgslam_torch.slam.mapper import Mapper
    from rtgslam_torch.utils.general import sync

    dataset_params = DatasetParams().extract(args)
    dataset = Dataset(dataset_params)

    ply_path, frame_num, iter_num = pick_model(
        args.save_path, cli.frame_id, cli.load_type)
    print(f"[metric] loading {ply_path}")

    # eval uses the looser opaque threshold (configs/base.yaml
    # renderer_opaque_threshold_eval, reference metric.py:138)
    args.renderer_opaque_threshold = getattr(
        args, "renderer_opaque_threshold_eval", args.renderer_opaque_threshold)
    mapper = Mapper(args, device)
    mapper.load_model(ply_path)

    pose_es_path = os.path.join(args.save_path, "save_traj", "pose_es.npy")
    pose_es = np.load(pose_es_path) if os.path.exists(pose_es_path) else None

    # geometry eval prefers the densified point cloud when slam_torch.py
    # wrote one (reference metric.py:156-157)
    pcd_rec_path = None
    if getattr(args, "pcd_densify", False):
        cand = os.path.join(args.save_path, "save_model", "pcd_densify.ply")
        if os.path.exists(cand):
            pcd_rec_path = cand
            print(f"[metric] geometry eval ply: {cand}")

    rows, frame_ms = [], []
    infos = dataset.scene_info.train_cameras
    n = len(infos) if cli.eval_frame_num == -1 else min(cli.eval_frame_num, len(infos))
    for frame_id in range(n):
        sync(device)
        t0 = time.perf_counter()
        frame = load_camera(dataset_params, frame_id, infos[frame_id])
        if pose_es is not None and frame_id < len(pose_es):
            frame.update_pose(pose_es[frame_id])
        mapper._ensure_settings(frame)
        run_pcd = frame_id == n - 1 and dataset.mesh_path is not None
        metrics = eval_frame(
            mapper, frame,
            save_path=os.path.join(args.save_path, "eval_metric"),
            min_depth=args.min_depth, max_depth=args.max_depth,
            save_picture=(frame_id % 20 == 0), run_pcd=run_pcd,
            pcd_gt_path=dataset.mesh_path, pcd_rec_path=pcd_rec_path)
        sync(device)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        metrics["frame"] = frame_id
        rows.append(metrics)
        print(f"[metric] frame {frame_id}: psnr {metrics['psnr']:.2f} "
              f"depthL1 {metrics['depth_l1_cm']:.2f}cm")

    out_csv = os.path.join(
        args.save_path, f"statis_frame_{frame_num}_iter_{iter_num}.csv")
    mean = write_statis_csv(out_csv, rows)
    print(f"[metric] wrote {out_csv}")
    print("[metric] mean " + "  ".join(
        f"{k} {v:.4f}" for k, v in mean.items() if k != "frame"))
    return {"csv": out_csv, "rows": rows, "mean": mean, "frame_ms": frame_ms}


if __name__ == "__main__":
    main()
