#!/usr/bin/env python
"""Pipelined (tracker || mapper) SLAM entry point of the PyTorch port
(``rtgslam_torch``), the twin of ``slam_mp.py``:

    python slam_mp_torch.py --config configs/synthetic/room.yaml [--frames N] [--device cuda|cpu]

The tracker and the mapper run as two threads, each on its own CUDA stream,
with the config's strict / loose / free sync policy
(``sync_tracker2mapper_method``, ``sync_tracker2mapper_frames``); a third
thread writes the mid-run checkpoints (``rtgslam_torch/slam/system.py``).
The run ends with the final global optimization, the model, the trajectory
with its ATE and ``performance.json``.

The device is CUDA unless ``--device cpu`` asks for the CPU; with no GPU
and no such flag the run stops.  ``device_list`` in the config picks the
cards (mapper first).  Run from the repository root: a config's relative
``parent:`` is read relative to the working directory.
"""

import sys
from argparse import ArgumentParser


def parse_args(argv=None):
    parser = ArgumentParser(description="RTG-SLAM, PyTorch + CUDA (pipelined)")
    parser.add_argument("--config", type=str, default="configs/replica/room0.yaml")
    parser.add_argument("--frames", type=int, default=-1,
                        help="override frame_num (quick runs)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    return parser.parse_args(argv)


def main(argv=None, priority_source=None):
    """Run the sequence the config names through the pipelined system.
    ``priority_source`` replaces the mapper's spawn priorities
    (``utils/threefry.py::jax_priorities`` replays the JAX package's).
    Returns the run's results (``SLAM.run``): ate_cm, fps, the threaded
    run's wall seconds, each frame's mapping end time, the loader's decode
    milliseconds, the mapper, tracker and recorder."""
    cli = parse_args(argv)
    from rtgslam_torch.config import read_config
    from rtgslam_torch.utils.general import require_device, safe_state

    device = require_device(cli.device)
    args = read_config(cli.config)
    if cli.frames != -1:
        args.frame_num = cli.frames
    args.mode = "multi process"
    stdout = sys.stdout
    safe_state(getattr(args, "quiet", False))
    try:
        return _run(args, device, priority_source)
    finally:
        sys.stdout = stdout


def _run(args, device, priority_source):
    from rtgslam_torch.config import (DatasetParams, OptimizationParams,
                                      save_config)
    from rtgslam_torch.data.dataset import Dataset
    from rtgslam_torch.slam.system import SLAM
    from rtgslam_torch.utils.general import create_workspace

    dataset = Dataset(DatasetParams().extract(args))
    create_workspace(args.save_path)
    save_config(args, args.save_path)
    slam = SLAM(args, dataset, OptimizationParams().extract(args), device,
                priority_source)
    return slam.run()


if __name__ == "__main__":
    main()
