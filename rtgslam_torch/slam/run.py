"""The per-frame SLAM loop of the forward slice.

``run_sequence`` runs the order of ``slam.py``'s single-process loop
(:125-157, non-band branch; ``bench.py::run_rep`` :114) and then its
end-of-run steps (:163-193): update poses, the final global pass and the
last keyframe's eval.  ``make_args`` is ``bench.py::make_args`` for this
package: the Replica operating point sized to (H, W), with the two
gradient-iteration counts at 0.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import read_config
from ..data.camera import Camera
from .eval import eval_frame
from .mapper import Mapper, PrioritySource
from .tracker import Tracker

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_args(H: int, W: int):
    """``bench.py::make_args(H, W, env_overrides=False)`` with
    ``gaussian_update_iter = final_global_iter = 0``."""
    args = read_config(os.path.join(REPO, "configs", "base.yaml"))
    args.memory_length = 5
    args.gaussian_update_iter = 0
    args.gaussian_update_frame = 6
    args.final_global_iter = 0
    args.stable_confidence_thres = 100
    args.unstable_time_window = 120
    args.uniform_sample_num = int(40800 * (H * W) / (680 * 1200))
    args.use_gt_pose = False
    args.icp_use_model_depth = True
    args.max_depth = 8.0
    args.save_step = 10 ** 9
    scale = (H * W) / (680 * 1200)
    args.map_capacity = max(16384, 1 << int(np.ceil(np.log2(400_000 * scale))))
    args.temp_capacity = max(4096, 1 << int(np.ceil(np.log2(65_000 * scale))))
    args.block_capacity = 4096
    args.tile_capacity = 512
    args.max_visible = args.map_capacity // 2
    return args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sequence(args, cams: List[Camera], device="cpu",
                 priority_source: Optional[PrioritySource] = None) -> Dict:
    """Track and map ``cams`` in order, then finish the run.

    Returns poses [N, 4, 4], ate_cm, the last keyframe's eval metrics
    (psnr, depth_l1_cm, ...), the final stable / unstable counts, the
    per-frame (unstable, stable) counts, max bin overflow, the per-frame
    tracking / mapping milliseconds (host clock around work that ends in a
    device synchronize) and the mapper."""
    device = torch.device(device)
    tracker = Tracker(args, device)
    mapper = Mapper(args, device, priority_source)
    track_ms, map_ms, counts = [], [], []
    for i, cam in enumerate(cams):
        _sync(device)
        t0 = time.perf_counter()
        fm = tracker.map_preprocess(cam, i)
        tracker.tracking(cam, fm)
        _sync(device)
        t1 = time.perf_counter()
        mapper.update_poses(tracker.get_new_poses())
        mapper.mapping(cam, fm, i)
        mapper.get_render_output(cam)
        tracker.update_last_status(
            cam, mapper.model_map["render_depth"], mapper.frame_map["depth_map"],
            mapper.model_map["render_normal"], mapper.frame_map["normal_map_w"])
        counts.append((mapper.get_unstable_num, mapper.get_stable_num))
        _sync(device)
        t2 = time.perf_counter()
        mapper.time += 1
        track_ms.append((t1 - t0) * 1e3)
        map_ms.append((t2 - t1) * 1e3)

    mapper.update_poses(tracker.get_new_poses())
    mapper.global_optimization()
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
        "mapper": mapper,
    }
