#!/usr/bin/env python
"""Single-process SLAM entry point of the PyTorch port (``rtgslam_torch``),
the twin of ``slam.py``:

    python slam_torch.py --config configs/synthetic/room.yaml [--frames N] [--device cuda|cpu]

Per frame: preprocess -> track -> update poses -> map -> model render ->
feed the model depth back to the tracker; every ``save_step`` frames (and
frame 0) an eval and a PLY checkpoint.  The run ends with the final global
optimization, the last keyframe's eval from a freshly loaded frame, the
trajectory export with its ATE, ``performance.json`` (fps = 1 / mean
mapping time) and, with ``pcd_densify``, the densified point cloud.

The device is CUDA unless ``--device cpu`` asks for the CPU; with no GPU
and no such flag the run stops.  ``RTG_PERF=1`` times the stages' host
spans (``rtgslam_torch/utils/perf.py``) and writes their report to
``<save_path>/perf.json`` at the end of the run; ``RTG_TRACE=<dir>``
writes a ``torch.profiler`` trace of the run there (with the spans'
``stage:`` ranges under ``RTG_PERF=1``).  Each stage's clock is read after a device
synchronize.  A config's ``frame_bands`` N > 1 (or ``--bands N``) runs
``slam.py``'s row-band path (``rtgslam_torch/slam/run.py::track_and_map_banded``):
each frame is tracked once on a copy downsampled by ``band_track_stride``,
then mapped as N row bands, and the final keyframe is scored band by band
(``[EVAL] final keyframe (banded xN)``); H must be a multiple of N.  Run
from the repository root: a config's relative ``parent:`` is read relative
to the working directory.
"""

import os
import sys
import time
from argparse import ArgumentParser


def parse_args(argv=None):
    parser = ArgumentParser(description="RTG-SLAM, PyTorch + CUDA")
    parser.add_argument("--config", type=str, default="configs/replica/room0.yaml")
    parser.add_argument("--frames", type=int, default=-1,
                        help="override frame_num (quick runs)")
    parser.add_argument("--bands", type=int, default=0,
                        help="override frame_bands: N > 1 maps each frame "
                             "as N row bands")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    return parser.parse_args(argv)


def main(argv=None, priority_source=None):
    """Run the sequence the config names.  ``priority_source`` replaces the
    mapper's spawn priorities (``utils/threefry.py::jax_priorities``
    replays the JAX package's).  Returns the run's results: ate_cm, the
    final keyframe's eval and its uid, the loader's decode milliseconds per
    frame, the mapper, tracker and recorder."""
    cli = parse_args(argv)
    from rtgslam_torch.config import read_config
    from rtgslam_torch.utils import perf
    from rtgslam_torch.utils.general import require_device, safe_state

    device = require_device(cli.device)
    args = read_config(cli.config)
    if cli.frames != -1:
        args.frame_num = cli.frames
    if cli.bands:
        args.frame_bands = cli.bands
    stdout = sys.stdout
    safe_state(getattr(args, "quiet", False))
    try:
        with perf.device_trace():   # RTG_TRACE=<dir>: a torch.profiler trace
            return _run(args, device, priority_source)
    finally:
        sys.stdout = stdout


def _run(args, device, priority_source):
    from rtgslam_torch.config import (DatasetParams, OptimizationParams,
                                      save_config)
    from rtgslam_torch.data.camera import load_camera
    from rtgslam_torch.data.dataset import Dataset
    from rtgslam_torch.data.loader import FrameLoader
    from rtgslam_torch.slam.eval import eval_frame
    from rtgslam_torch.slam.mapper import Mapper
    from rtgslam_torch.slam.run import eval_banded, track_and_map_banded
    from rtgslam_torch.slam.tracker import Tracker
    from rtgslam_torch.utils import perf
    from rtgslam_torch.utils.general import create_workspace, sync
    from rtgslam_torch.utils.monitor import Recorder

    n_bands = int(getattr(args, "frame_bands", 1))
    track_settings = None
    recorder = Recorder(device.index or 0,
                        record_mem=getattr(args, "record_mem", False))
    opt = OptimizationParams().extract(args)
    dataset_params = DatasetParams().extract(args)
    dataset = Dataset(dataset_params)
    create_workspace(args.save_path)
    save_config(args, args.save_path)

    mapper = Mapper(args, device, priority_source)
    tracker = Tracker(args, device)
    frame_infos = dataset.scene_info.train_cameras
    eval_dir = os.path.join(args.save_path, "eval_render")

    loader = FrameLoader(dataset_params, frame_infos, prefetch=4)
    try:
        for frame_id, frame in enumerate(loader):
            print(f"========== curr frame is: {frame_id} ==========")
            if n_bands > 1:
                eval_cam, track_settings, tracker_time, mapper_time = \
                    track_and_map_banded(args, tracker, mapper, frame,
                                         frame_id, opt, track_settings)
                recorder.update_mean("tracking", tracker_time, 1)
            else:
                sync(device)
                start = time.perf_counter()
                frame_map = tracker.map_preprocess(frame, frame_id)
                tracker.tracking(frame, frame_map)
                sync(device)
                map_start = time.perf_counter()
                tracker_time = map_start - start
                recorder.update_mean("tracking", tracker_time, 1)

                mapper.update_poses(tracker.get_new_poses())
                mapper.mapping(frame, frame_map, frame_id, opt)
                mapper.get_render_output(frame)
                tracker.update_last_status(
                    frame,
                    mapper.model_map["render_depth"],
                    mapper.frame_map["depth_map"],
                    mapper.model_map["render_normal"],
                    mapper.frame_map["normal_map_w"],
                )
                sync(device)
                mapper_time = time.perf_counter() - map_start
                eval_cam = frame
            recorder.update_mean("mapping", mapper_time, 1)
            if recorder.record_mem:
                recorder.watch_memory()
            print(f"[LOG] tracker {tracker_time*1e3:.1f} ms  mapper {mapper_time*1e3:.1f} ms")

            if (mapper.time + 1) % mapper.save_step == 0 or mapper.time == 0:
                metrics = eval_frame(
                    mapper, eval_cam, eval_dir,
                    min_depth=args.min_depth, max_depth=args.max_depth,
                    save_picture=True)
                print(f"[EVAL] frame {frame_id}: psnr {metrics['psnr']:.2f} "
                      f"depthL1 {metrics['depth_l1_cm']:.2f}cm")
                mapper.save_model(save_data=True)
            mapper.time += 1
    finally:
        loader.close()

    print("========== main loop finish ==========")
    print(f"[LOG] stable num: {mapper.get_stable_num}, "
          f"unstable num: {mapper.get_unstable_num}")

    mapper.update_poses(tracker.get_new_poses())
    mapper.global_optimization(opt)
    final_eval, final_uid = None, None
    if mapper.keyframe_list:
        kf = mapper.keyframe_list[-1]["frame"]
        kf_full = load_camera(dataset_params, kf.uid, frame_infos[kf.uid])
        kf_full.update(kf.R, kf.T)
        final_uid = kf.uid
        scoring = dict(save_path=eval_dir, min_depth=args.min_depth,
                       max_depth=args.max_depth, save_picture=True)
        if n_bands > 1:
            # each band writes frame_<uid>.json over the last, as in JAX
            final_eval = eval_banded(mapper, kf_full, n_bands, **scoring)
            print(f"[EVAL] final keyframe (banded x{n_bands}): "
                  f"psnr {final_eval['psnr']:.2f} "
                  f"depthL1 {final_eval['depth_l1_cm']:.2f}cm")
        else:
            final_eval = eval_frame(mapper, kf_full, **scoring)
            print(f"[EVAL] final keyframe {kf.uid}: psnr {final_eval['psnr']:.2f} "
                  f"depthL1 {final_eval['depth_l1_cm']:.2f}cm")
    mapper.save_model(save_data=True)
    ate = tracker.save_traj(args.save_path)
    fps = recorder.cal_fps()
    recorder.save(args.save_path)
    if perf.ENABLED:
        perf.dump(os.path.join(args.save_path, "perf.json"))
    print(f"[LOG] ATE RMSE: {ate:.3f} cm  mapping FPS: {fps:.2f}  "
          f"max bin_overflow: {mapper.max_overflow} "
          f"(JAX's count, lifecycle renders: {mapper.lifecycle_overflow})")
    if n_bands > 1:
        print(f"[LOG] feedback renders (tracking size) max bin_overflow: "
              f"{mapper.max_feedback_overflow}")

    if getattr(args, "pcd_densify", False):
        from rtgslam_torch.models.densify import save_densified_ply
        from rtgslam_torch.models.gaussian_map import STABLE, to_numpy_dict

        data = to_numpy_dict(mapper.state, STABLE)
        if data["xyz"].shape[0]:
            n = save_densified_ply(
                os.path.join(args.save_path, "save_model", "pcd_densify.ply"),
                data["xyz"], data["scaling"], data["rotation"],
                sigma=1, circle_num=30, levels=5)
            print(f"[LOG] densified pcd: {n} points")
    return {"ate_cm": ate, "final_eval": final_eval, "final_eval_uid": final_uid,
            "decode_ms": dict(loader.decode_ms),
            "mapper": mapper, "tracker": tracker, "recorder": recorder}


if __name__ == "__main__":
    main()
