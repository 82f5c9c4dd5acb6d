"""Drive the port through SLAM sessions: the timed path of every cell.

A session is ``slam.py``'s single-process run of one sequence with a fresh
``Tracker`` and ``Mapper`` (``rtgslam_torch/slam/run.py::run_sequence``'s
per-frame order): ``map_preprocess`` + ``tracking``, a synchronize; then
``update_poses``, ``mapping``, ``get_render_output``,
``update_last_status``, a synchronize.  At the end of the sequence come the
final pass (``Mapper.global_optimization``) and the eval render of the last
keyframe.  :func:`run_window` runs whole sessions back to back until the
window's seconds are spent and records every frame.

Every session does the same work: the frames come from the traffic file
and the mapper draws its spawn priorities from the program's own default
source (``generator_priorities``), as ``slam.py`` does.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from rtgslam_torch.config import OptimizationParams
from rtgslam_torch.config.loader import GroupParams
from rtgslam_torch.data.camera import Camera
from rtgslam_torch.slam.eval import eval_picture
from rtgslam_torch.slam.mapper import Mapper
from rtgslam_torch.slam.tracker import Tracker

import scene


def make_args(config: Dict):
    """The port's argument namespace from a configuration file's ``args``;
    the run directory goes under the temporary directory (nothing is
    written there: no checkpoint step is reached, TensorBoard is off)."""
    args = GroupParams()
    for key, value in config["args"].items():
        setattr(args, key, value)
    args.save_path = os.path.join(tempfile.gettempdir(), "rtgslam_benchmark")
    return args


def gradient_frames(args, n_frames: int) -> List[int]:
    """The frames whose mapping runs a gradient pass (``Mapper.mapping``:
    frame 0 and every ``gaussian_update_frame``-th)."""
    every = int(args.gaussian_update_frame)
    return [i for i in range(n_frames) if i == 0 or (i + 1) % every == 0]


def cameras(seq: Dict) -> List[Camera]:
    """Fresh ``Camera`` objects over the host frames (the tracker writes its
    poses into them, so every session takes its own)."""
    K = seq["K"]
    cams = []
    for i, (colour, depth, c2w) in enumerate(zip(seq["colour"], seq["depth"],
                                                 seq["poses"])):
        H, W = colour.shape[:2]
        w2c = np.linalg.inv(c2w)
        cams.append(Camera(
            uid=i, R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3],
            FoVx=scene.fov(K[0, 0], W), FoVy=scene.fov(K[1, 1], H),
            image=colour, depth=depth, image_name=str(i), cx=K[0, 2],
            cy=K[1, 2], timestamp=i / 30.0, depth_scale=seq["depth_scale"],
            pose_gt=c2w))
    return cams


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Hooks:
    """What a session calls around its steps.  The defaults do nothing;
    ``run.py``'s hooks profile a slice of frames (``frame_start``,
    ``frame_end``, ``stage``) and keep the first session's outputs for the
    check (every hook but ``stage``).  ``paused_s``: seconds of
    instrument set-up that the window's deadline does not count."""

    paused_s = 0.0

    def session_start(self, session: int, tracker, mapper) -> None:
        pass

    def frame_start(self, session: int, index: int) -> None:
        pass

    def frame_end(self, session: int, index: int) -> None:
        pass

    def stage(self, name: str):
        return contextlib.nullcontext()

    def session_end(self, session: int, result: Dict) -> None:
        pass


def run_session(args, seq: Dict, device, session: int, hooks: Hooks,
                frames: List[Dict]) -> Dict:
    """One whole session over ``seq``.  Appends a record per frame to
    ``frames``; returns the session's own record."""
    opt = OptimizationParams().extract(args)
    tracker = Tracker(args, device)
    mapper = Mapper(args, device)
    cams = cameras(seq)
    hooks.session_start(session, tracker, mapper)
    for i, cam in enumerate(cams):
        hooks.frame_start(session, i)
        sync(device)
        t0 = time.perf_counter()
        with hooks.stage("track"):
            fm = tracker.map_preprocess(cam, i)
            ok = tracker.tracking(cam, fm)
        sync(device)
        t1 = time.perf_counter()
        gradient = (i == 0 or (i + 1) % mapper.gaussian_update_frame == 0)
        with hooks.stage("map.gradient" if gradient else "map.plain"):
            mapper.update_poses(tracker.get_new_poses())
            mapper.mapping(cam, fm, i, opt)
            mapper.get_render_output(cam)
            tracker.update_last_status(
                cam, mapper.model_map["render_depth"],
                mapper.frame_map["depth_map"], mapper.model_map["render_normal"],
                mapper.frame_map["normal_map_w"])
        sync(device)
        t2 = time.perf_counter()
        mapper.time += 1
        frames.append({"session": session, "index": i, "ok": bool(ok),
                       "gradient": gradient, "track_ms": (t1 - t0) * 1e3,
                       "map_ms": (t2 - t1) * 1e3, "end": t2})
        hooks.frame_end(session, i)

    t0 = time.perf_counter()
    with hooks.stage("final"):
        mapper.update_poses(tracker.get_new_poses())
        mapper.global_optimization(opt)
        eval_cam = cams[mapper.keyframe_list[-1]["frame"].uid]
        out = mapper._render(eval_cam.device_dict(mapper.device))
        scores = eval_picture(out, eval_cam.image, eval_cam.depth)
    sync(device)
    result = {"session": session, "frames": len(cams),
              "final_ms": (time.perf_counter() - t0) * 1e3,
              "eval_uid": eval_cam.uid, "eval_psnr_port": scores["psnr"],
              "keyframes": [kf["frame"].uid for kf in mapper.keyframe_list],
              "overflow": max(int(mapper.max_overflow),
                              int(scores["bin_overflow"])),
              "poses": np.stack([np.asarray(p, np.float64)
                                 for p in tracker.pose_es]),
              "status": {k: int(v) for k, v in tracker.status.items()},
              "end": time.perf_counter()}
    hooks.session_end(session, {"mapper": mapper, "render": out,
                                "camera": eval_cam})
    return result


def run_window(args, seq: Dict, device, seconds: float, hooks: Hooks) -> Dict:
    """Whole sessions back to back until ``seconds`` have passed: the
    session under way at the deadline runs to its end, so the window holds
    whole sessions and every frame and end-of-session pass in it counts.
    Returns the frame records, the session records and the window's wall
    seconds (less the instruments' start and stop, ``hooks.paused_s``)."""
    frames: List[Dict] = []
    sessions: List[Dict] = []
    sync(device)
    start = time.perf_counter()
    end = start
    while end - start - hooks.paused_s < seconds:
        res = run_session(args, seq, device, len(sessions), hooks, frames)
        sessions.append(res)
        end = res["end"]
    return {"frames": frames, "sessions": sessions,
            "window_s": end - start - hooks.paused_s, "start": start}


def warm_up(args, seq: Dict, device) -> None:
    """Set-up's discarded session: the sequence's first frames up to and
    including its second gradient frame, then the final pass and the eval
    render, so every kernel is loaded and every shape has run once."""
    last = gradient_frames(args, len(seq["colour"]))[1]
    short = dict(seq, colour=seq["colour"][:last + 1],
                 depth=seq["depth"][:last + 1], poses=seq["poses"][:last + 1])
    run_session(args, short, device, -1, Hooks(), [])
