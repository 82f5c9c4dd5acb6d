#!/usr/bin/env python
"""Benchmark of the PyTorch port (``rtgslam_torch``): online tracking and
mapping fps on the procedural room, the twin of ``bench.py``.

    python bench_torch.py                       # on the GPU
    BENCH_PLATFORM=cpu python bench_torch.py    # on the CPU

Prints ONE JSON line, ``bench.py``'s metric and keys:

  {"metric": "synthetic_room_online_mapping_fps", "value": N, "unit": "fps",
   "vs_baseline": N, "detail": {...}}

``value`` follows the reference rule fps = 1 / mean(mapping time), the
median over the reps; ``vs_baseline`` divides it by the north star of 30
fps.  Each rep is ``bench.py::run_rep``'s loop with a fresh tracker and
mapper (no pose refresh, no final global pass); the warm-up frames are left
out of the clocks, and the mapping clock stops after a device synchronize.
The last rep's map is scored on the last frame.  Environment:

  BENCH_H / BENCH_W   frame size        (default 170 x 300)
  BENCH_FRAMES        frames            (default 40)
  BENCH_WARMUP        frames not timed  (default 12)
  BENCH_REPS          fresh-state reps  (default 3)
  BENCH_PLATFORM      ``cpu`` runs on the CPU; otherwise the run needs CUDA
  BENCH_MAP_CAPACITY / _TEMP_ / _TILE_ / _BLOCK_CAPACITY,
  BENCH_FREEZE_BINNING                  ``make_args``' overrides
  RTG_PERF=1          adds ``detail.perf``, the host spans of each stage
  RTG_TRACE=<dir>     writes a torch.profiler trace of the run there

Quality gates exit 2 after the line: ``bin_overflow != 0`` always, and
``psnr < 27.5`` or ``ate_cm > 0.5`` at the default 170 x 300 x 40.
"""

import json
import os
import sys
import time
from argparse import ArgumentParser

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

METRIC = "synthetic_room_online_mapping_fps"
BASELINE_FPS = 30.0
DEFAULT_SIZE = (170, 300, 40)


def run_rep(args, opt, cams, warmup, device, priority_source=None):
    """One tracking + mapping pass over ``cams`` with a fresh tracker and
    mapper (``bench.py::run_rep`` :114).  Returns the tracking and mapping
    seconds of the frames after ``warmup``, the tracker and the mapper."""
    from rtgslam_torch.slam.mapper import Mapper
    from rtgslam_torch.slam.tracker import Tracker
    from rtgslam_torch.utils.general import sync

    tracker = Tracker(args, device)
    mapper = Mapper(args, device, priority_source)
    track_times, map_times = [], []
    for i, cam in enumerate(cams):
        t0 = time.perf_counter()
        fm = tracker.map_preprocess(cam, i)
        tracker.tracking(cam, fm)
        t1 = time.perf_counter()
        mapper.mapping(cam, fm, i, opt)
        mapper.get_render_output(cam)
        tracker.update_last_status(
            cam, mapper.model_map["render_depth"], mapper.frame_map["depth_map"],
            mapper.model_map["render_normal"], mapper.frame_map["normal_map_w"])
        mapper.time += 1
        sync(device)    # charge the mapping work to the mapping stage
        t2 = time.perf_counter()
        if i >= warmup:
            track_times.append(t1 - t0)
            map_times.append(t2 - t1)
    return track_times, map_times, tracker, mapper


def bench(args, cams, warmup, n_reps, device, priority_source=None):
    """Run ``n_reps`` reps over ``cams`` and score the last one.  Returns
    the result line (a dict), the last rep's tracker and mapper."""
    from rtgslam_torch.config import OptimizationParams
    from rtgslam_torch.slam.eval import eval_frame
    from rtgslam_torch.utils import perf

    opt = OptimizationParams().extract(args)
    rep_fps, rep_map_med, rep_track_med = [], [], []
    for _ in range(max(1, n_reps)):
        track_times, map_times, tracker, mapper = run_rep(
            args, opt, cams, warmup, device, priority_source)
        rep_fps.append(1.0 / float(np.mean(map_times)) if map_times else 0.0)
        rep_map_med.append(float(np.median(map_times)) * 1e3)
        rep_track_med.append(float(np.median(track_times)) * 1e3)

    mean_mapping = float(np.mean(map_times))
    mean_tracking = float(np.mean(track_times))
    med_mapping = float(np.median(rep_map_med)) / 1e3
    med_tracking = float(np.median(rep_track_med)) / 1e3
    fps = float(np.median(rep_fps))
    metrics = eval_frame(mapper, cams[-1])
    # the run-wide high-water mark, not only the eval frame's render
    overflow = max(int(mapper.max_overflow), int(metrics["bin_overflow"]))
    # bench.py's rule over the JAX mapper's count (lifecycle renders, the
    # last one not folded): what bench.py's bin_overflow reads; no gate
    lifecycle = max(int(mapper.lifecycle_overflow), int(metrics["bin_overflow"]))
    H, W = cams[-1].image_height, cams[-1].image_width
    result = {
        "metric": METRIC,
        "value": round(fps, 3),
        "unit": "fps",
        "vs_baseline": round(fps / BASELINE_FPS, 4),
        "detail": {
            "H": H, "W": W, "frames": len(cams), "reps": max(1, n_reps),
            "rep_fps": [round(f, 3) for f in rep_fps],
            "rep_median_mapping_ms": [round(m, 2) for m in rep_map_med],
            "mean_tracking_ms": round(mean_tracking * 1e3, 2),
            "mean_mapping_ms": round(mean_mapping * 1e3, 2),
            "median_tracking_ms": round(med_tracking * 1e3, 2),
            "median_mapping_ms": round(med_mapping * 1e3, 2),
            "fps_reference_mean_rule": round(
                1.0 / mean_mapping if mean_mapping > 0 else 0.0, 3),
            "fps_median_rule": round(
                1.0 / med_mapping if med_mapping > 0 else 0.0, 3),
            "e2e_fps": round(1.0 / (med_tracking + med_mapping), 3),
            "ate_cm": round(float(tracker.eval_ate()), 4),
            "psnr": round(float(metrics["psnr"]), 3),
            "depth_l1_cm": round(float(metrics["depth_l1_cm"]), 4),
            "gaussians": mapper.get_unstable_num + mapper.get_stable_num,
            "bin_overflow": overflow,
            "lifecycle_overflow": lifecycle,
        },
    }
    if perf.ENABLED:
        result["detail"]["perf"] = perf.report()
    return result, tracker, mapper


def quality_gates(result) -> list:
    """The failed gates (``bench.py:244-257``): bin overflow at any size;
    PSNR and ATE at the default size, where their floors were set."""
    d = result["detail"]
    gates = []
    if d["bin_overflow"]:
        gates.append(f"bin_overflow={d['bin_overflow']} != 0 (undersized "
                     "tile/block capacity: numbers not trustworthy)")
    if (d["H"], d["W"], d["frames"]) == DEFAULT_SIZE:
        if d["psnr"] < 27.5:
            gates.append(f"psnr={d['psnr']:.2f} < 27.5")
        if d["ate_cm"] > 0.5:
            gates.append(f"ate_cm={d['ate_cm']:.3f} > 0.5")
    return gates


def main(argv=None, priority_source=None):
    """Run the benchmark the environment describes and print its line.
    ``priority_source`` replaces the mappers' spawn priorities
    (``utils/threefry.py::jax_priorities`` replays the JAX package's).
    Returns the result; exits 2 when a quality gate fails."""
    ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    from rtgslam_torch.data.synthetic import make_cameras
    from rtgslam_torch.slam.run import make_args
    from rtgslam_torch.utils import perf
    from rtgslam_torch.utils.general import require_device

    platform = os.environ.get("BENCH_PLATFORM", "cuda")
    device = require_device("cpu" if platform == "cpu" else "cuda")
    H = int(os.environ.get("BENCH_H", DEFAULT_SIZE[0]))
    W = int(os.environ.get("BENCH_W", DEFAULT_SIZE[1]))
    n_frames = int(os.environ.get("BENCH_FRAMES", DEFAULT_SIZE[2]))
    warmup = int(os.environ.get("BENCH_WARMUP", 12))
    n_reps = int(os.environ.get("BENCH_REPS", 3))

    args = make_args(H, W, env_overrides=True)
    cams = make_cameras(n_frames=n_frames, H=H, W=W)
    with perf.device_trace():
        result, _, _ = bench(args, cams, warmup, n_reps, device, priority_source)
    print(json.dumps(result), flush=True)
    gates = quality_gates(result)
    if gates:
        sys.stderr.write("[bench] FATAL quality gate: " + "; ".join(gates) + "\n")
        sys.exit(2)
    return result


if __name__ == "__main__":
    main()
