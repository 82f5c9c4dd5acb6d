"""The per-frame SLAM loop.

``run_sequence`` runs the order of ``slam.py``'s single-process loop
(:125-157; with ``frame_bands`` > 1 the banded step of :71-123,
:func:`track_and_map_banded`) and then its end-of-run steps (:163-193):
update poses, the final global pass and the last keyframe's eval, band by
band when the frames are banded (:func:`eval_banded`, :169-186)
(``bench_torch.py`` runs ``bench.py::run_rep``'s order instead).
``make_args`` is ``bench.py::make_args`` for this package: the Replica
operating point sized to (H, W), 50 gradient iterations every 6th frame and
10 final-pass iterations per keyframe.  A caller that wants the
forward-only loop sets ``gaussian_update_iter`` and ``final_global_iter``
to 0.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import OptimizationParams, read_config
from ..data.bands import downsample_camera, split_bands
from ..data.camera import Camera
from ..ops.rasterize import RasterSettings
from ..utils.general import require_device, sync
from .eval import eval_frame
from .mapper import Mapper, PrioritySource
from .tracker import Tracker, preprocess_and_lift

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


def track_and_map_banded(args, tracker: Tracker, mapper: Mapper, frame: Camera,
                         frame_id: int, opt,
                         track_settings: Optional[RasterSettings] = None):
    """One frame of ``slam.py``'s row-band step (:71-123): track once on a
    copy downsampled by ``band_track_stride`` (``frame_bands`` unless set),
    map each of the ``frame_bands`` row bands (``data/bands.py``, the
    order rotated by ``frame_id``) with the tracked pose, advancing
    ``mapper.time`` once per band, and feed the model render at the track
    camera's size back to the tracker.  The caller adds 1 to
    ``mapper.time`` after its per-frame tail, as for a whole frame.

    ``track_settings`` is the render size of the feedback; pass what the
    first call returned.  Returns (the camera of the in-loop eval, the
    rotated first band; track_settings; tracking seconds; mapping
    seconds), each clock read after a device synchronize."""
    n_bands = int(args.frame_bands)
    track_cam = downsample_camera(frame, int(getattr(args, "band_track_stride",
                                                     n_bands)))
    if track_settings is None:
        track_settings = RasterSettings.from_args(
            args, track_cam.image_height, track_cam.image_width)
    dev = mapper.device
    sync(dev)
    start = time.perf_counter()
    frame_map = tracker.map_preprocess(track_cam, frame_id)
    tracker.tracking(track_cam, frame_map)
    sync(dev)
    map_start = time.perf_counter()
    frame.update(track_cam.R, track_cam.T)   # the tracked pose -> the frame

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    mapper.update_poses(tracker.get_new_poses())
    bands = split_bands(frame, n_bands, rotate=frame_id)
    for bcam in bands:
        bfm = preprocess_and_lift(
            tensor(bcam.depth), tensor(bcam.image), tensor(bcam.intrinsic),
            tensor(bcam.c2w), args.min_depth, args.max_depth,
            tracker.invalid_confidence_thresh, tracker.depth_filter)
        bfm["time"] = frame_id
        mapper.mapping(bcam, bfm, frame_id, opt)
        mapper.time += 1
    mapper.time -= 1   # the caller's tail adds the last one
    # the model at the track camera's size, rendered afresh (every band and
    # the track camera share the frame's uid, so no cached render serves)
    out = mapper._render(track_cam.device_dict(dev), settings=track_settings,
                         feedback=True)
    mapper._set_model_map(out)
    tracker.update_last_status(
        track_cam, mapper.model_map["render_depth"], frame_map["depth_map"],
        mapper.model_map["render_normal"], frame_map["normal_map_w"])
    sync(dev)
    return (bands[0], track_settings, map_start - start,
            time.perf_counter() - map_start)


def eval_banded(mapper: Mapper, cam: Camera, n_bands: int, **kw) -> Dict:
    """``slam.py``'s banded final eval (:169-186): ``eval_frame`` (with
    ``kw``) on each of ``cam``'s ``n_bands`` row bands in order.  The bands
    hold equal pixel counts, so the frame's PSNR is -10 log10 of the
    bands' mean squared error; depth L1 is the bands' mean.  Returns psnr,
    depth_l1_cm, bin_overflow (the largest band's) and each band's
    metrics."""
    per_band = [eval_frame(mapper, b, **kw) for b in split_bands(cam, n_bands)]
    mse = sum(10.0 ** (-m["psnr"] / 10.0) for m in per_band) / n_bands
    return {"psnr": -10.0 * math.log10(mse),
            "depth_l1_cm": sum(m["depth_l1_cm"] for m in per_band) / n_bands,
            "bin_overflow": max(m["bin_overflow"] for m in per_band),
            "bands": per_band}


def run_sequence(args, cams: List[Camera], device="cuda",
                 priority_source: Optional[PrioritySource] = None,
                 mesh=None) -> Dict:
    """Track and map ``cams`` in order on ``device`` (CUDA unless the caller
    asks for the CPU), then finish the run; ``mesh`` goes to the
    :class:`Mapper`.

    Returns poses [N, 4, 4], ate_cm, the last keyframe's eval metrics
    (psnr, depth_l1_cm, ...), the final stable / unstable counts, the
    per-frame (unstable, stable) counts, max bin overflow (the mapper's
    ``max_overflow`` and the eval render's), ``lifecycle_overflow`` (the same
    with JAX's count, ``Mapper.lifecycle_overflow``, in place of the port's:
    the last frame's lifecycle render not folded in, as when ``slam.py``
    prints it), the per-frame
    tracking / mapping milliseconds (host clock around work that ends in a
    device synchronize), which frames ran a gradient pass, the final pass's
    milliseconds, the mapper and the tracker; banded, the eval's bands and
    the feedback renders' max overflow."""
    device = require_device(device)
    opt = OptimizationParams().extract(args)
    tracker = Tracker(args, device)
    mapper = Mapper(args, device, priority_source, mesh)
    n_bands = int(getattr(args, "frame_bands", 1))
    track_settings = None
    track_ms, map_ms, counts = [], [], []
    for i, cam in enumerate(cams):
        if n_bands > 1:
            _, track_settings, track_s, map_s = track_and_map_banded(
                args, tracker, mapper, cam, i, opt, track_settings)
            counts.append((mapper.get_unstable_num, mapper.get_stable_num))
        else:
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
            track_s, map_s = t1 - t0, time.perf_counter() - t1
        mapper.time += 1
        track_ms.append(track_s * 1e3)
        map_ms.append(map_s * 1e3)

    mapper.update_poses(tracker.get_new_poses())
    sync(device)
    t0 = time.perf_counter()
    mapper.global_optimization(opt)
    sync(device)
    final_ms = (time.perf_counter() - t0) * 1e3
    eval_cam = cams[mapper.keyframe_list[-1]["frame"].uid]
    metrics = (eval_banded(mapper, eval_cam, n_bands) if n_bands > 1
               else eval_frame(mapper, eval_cam))
    return {
        "poses": np.stack(tracker.pose_es),
        "ate_cm": tracker.eval_ate(),
        "eval": metrics,
        "eval_uid": eval_cam.uid,
        "n_stable": mapper.get_stable_num,
        "n_unstable": mapper.get_unstable_num,
        "counts": counts,
        "max_overflow": max(mapper.max_overflow, metrics["bin_overflow"]),
        "lifecycle_overflow": max(mapper.lifecycle_overflow,
                                  metrics["bin_overflow"]),
        "feedback_overflow": mapper.max_feedback_overflow,
        "track_ms": track_ms,
        "map_ms": map_ms,
        "optimize_frames": mapper.optimize_frames_ids,
        "final_ms": final_ms,
        "mapper": mapper,
        "tracker": tracker,
    }
