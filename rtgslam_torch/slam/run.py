"""The per-frame SLAM loop.

``run_sequence`` runs the order of ``slam.py``'s single-process loop
(:125-157, non-band branch) and then its end-of-run steps (:163-193):
update poses, the final global pass and the last keyframe's eval
(``bench_torch.py`` runs ``bench.py::run_rep``'s order instead).
``make_args`` is ``bench.py::make_args`` for this package: the Replica
operating point sized to (H, W), 50 gradient iterations every 6th frame and
10 final-pass iterations per keyframe.  A caller that wants the
forward-only loop sets ``gaussian_update_iter`` and ``final_global_iter``
to 0.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

from ..config import OptimizationParams, read_config
from ..data.camera import Camera
from ..utils.general import require_device, sync
from .eval import eval_frame
from .mapper import Mapper, PrioritySource
from .tracker import Tracker

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_args(H: int, W: int, env_overrides: bool = False):
    """``bench.py::make_args(H, W, env_overrides)``: the Replica operating
    point sized to (H, W).  With ``env_overrides`` the capacities take
    ``BENCH_MAP_CAPACITY`` / ``BENCH_TEMP_CAPACITY`` /
    ``BENCH_TILE_CAPACITY`` / ``BENCH_BLOCK_CAPACITY`` and frozen binning
    ``BENCH_FREEZE_BINNING`` from the environment (bench.py:79-89)."""
    args = read_config(os.path.join(REPO, "configs", "base.yaml"))
    args.memory_length = 5
    args.gaussian_update_iter = 50
    args.gaussian_update_frame = 6
    args.stable_confidence_thres = 100
    args.unstable_time_window = 120
    args.uniform_sample_num = int(40800 * (H * W) / (680 * 1200))
    args.use_gt_pose = False
    args.icp_use_model_depth = True
    args.max_depth = 8.0
    args.save_step = 10 ** 9
    args.save_path = os.path.join(tempfile.gettempdir(), "bench_run")
    scale = (H * W) / (680 * 1200)
    args.map_capacity = max(16384, 1 << int(np.ceil(np.log2(400_000 * scale))))
    args.temp_capacity = max(4096, 1 << int(np.ceil(np.log2(65_000 * scale))))
    args.block_capacity = 4096
    args.tile_capacity = 512
    args.optimize_freeze_binning = False
    if env_overrides:
        for attr, env in (("map_capacity", "BENCH_MAP_CAPACITY"),
                          ("temp_capacity", "BENCH_TEMP_CAPACITY"),
                          ("tile_capacity", "BENCH_TILE_CAPACITY"),
                          ("block_capacity", "BENCH_BLOCK_CAPACITY")):
            if env in os.environ:
                setattr(args, attr, int(os.environ[env]))
        args.optimize_freeze_binning = bool(
            int(os.environ.get("BENCH_FREEZE_BINNING", "0")))
    args.max_visible = args.map_capacity // 2
    return args


def run_sequence(args, cams: List[Camera], device="cuda",
                 priority_source: Optional[PrioritySource] = None,
                 mesh=None) -> Dict:
    """Track and map ``cams`` in order on ``device`` (CUDA unless the caller
    asks for the CPU), then finish the run; ``mesh`` goes to the
    :class:`Mapper`.

    Returns poses [N, 4, 4], ate_cm, the last keyframe's eval metrics
    (psnr, depth_l1_cm, ...), the final stable / unstable counts, the
    per-frame (unstable, stable) counts, max bin overflow, the per-frame
    tracking / mapping milliseconds (host clock around work that ends in a
    device synchronize), which frames ran a gradient pass, the final pass's
    milliseconds, the mapper and the tracker."""
    device = require_device(device)
    opt = OptimizationParams().extract(args)
    tracker = Tracker(args, device)
    mapper = Mapper(args, device, priority_source, mesh)
    track_ms, map_ms, counts = [], [], []
    for i, cam in enumerate(cams):
        sync(device)
        t0 = time.perf_counter()
        fm = tracker.map_preprocess(cam, i)
        tracker.tracking(cam, fm)
        sync(device)
        t1 = time.perf_counter()
        mapper.update_poses(tracker.get_new_poses())
        mapper.mapping(cam, fm, i, opt)
        mapper.get_render_output(cam)
        tracker.update_last_status(
            cam, mapper.model_map["render_depth"], mapper.frame_map["depth_map"],
            mapper.model_map["render_normal"], mapper.frame_map["normal_map_w"])
        counts.append((mapper.get_unstable_num, mapper.get_stable_num))
        sync(device)
        t2 = time.perf_counter()
        mapper.time += 1
        track_ms.append((t1 - t0) * 1e3)
        map_ms.append((t2 - t1) * 1e3)

    mapper.update_poses(tracker.get_new_poses())
    sync(device)
    t0 = time.perf_counter()
    mapper.global_optimization(opt)
    sync(device)
    final_ms = (time.perf_counter() - t0) * 1e3
    eval_cam = cams[mapper.keyframe_list[-1]["frame"].uid]
    metrics = eval_frame(mapper, eval_cam)
    return {
        "poses": np.stack(tracker.pose_es),
        "ate_cm": tracker.eval_ate(),
        "eval": metrics,
        "eval_uid": eval_cam.uid,
        "n_stable": mapper.get_stable_num,
        "n_unstable": mapper.get_unstable_num,
        "counts": counts,
        "max_overflow": max(mapper.max_overflow, metrics["bin_overflow"]),
        "track_ms": track_ms,
        "map_ms": map_ms,
        "optimize_frames": mapper.optimize_frames_ids,
        "final_ms": final_ms,
        "mapper": mapper,
        "tracker": tracker,
    }
