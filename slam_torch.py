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
and no such flag the run stops.  Each stage's clock is read after a device
synchronize.  A config's ``frame_bands`` is not ported (row bands served a
TPU worker's dispatch limit): frames run whole.  Run from the repository
root: a config's relative ``parent:`` is read relative to the working
directory.
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
    from rtgslam_torch.utils.general import require_device, safe_state

    device = require_device(cli.device)
    args = read_config(cli.config)
    if cli.frames != -1:
        args.frame_num = cli.frames
    stdout = sys.stdout
    safe_state(getattr(args, "quiet", False))
    try:
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
    from rtgslam_torch.slam.tracker import Tracker
    from rtgslam_torch.utils.general import create_workspace, sync
    from rtgslam_torch.utils.monitor import Recorder

    n_bands = int(getattr(args, "frame_bands", 1))
    if n_bands > 1:
        print(f"[LOG] frame_bands {n_bands}: row bands are not ported, "
              "frames run whole")
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
            recorder.update_mean("mapping", mapper_time, 1)
            if recorder.record_mem:
                recorder.watch_memory()
            print(f"[LOG] tracker {tracker_time*1e3:.1f} ms  mapper {mapper_time*1e3:.1f} ms")

            if (mapper.time + 1) % mapper.save_step == 0 or mapper.time == 0:
                metrics = eval_frame(
                    mapper, frame, eval_dir,
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
        final_eval = eval_frame(mapper, kf_full, eval_dir,
                                min_depth=args.min_depth, max_depth=args.max_depth,
                                save_picture=True)
        final_uid = kf.uid
        print(f"[EVAL] final keyframe {kf.uid}: psnr {final_eval['psnr']:.2f} "
              f"depthL1 {final_eval['depth_l1_cm']:.2f}cm")
    mapper.save_model(save_data=True)
    ate = tracker.save_traj(args.save_path)
    fps = recorder.cal_fps()
    recorder.save(args.save_path)
    print(f"[LOG] ATE RMSE: {ate:.3f} cm  mapping FPS: {fps:.2f}  "
          f"max bin_overflow: {mapper.max_overflow}")

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
