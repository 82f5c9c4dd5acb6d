"""Tracking front-end: frame preprocessing + pose estimation.

Port of ``rtgslam_tpu/slam/tracker.py`` (reference
``SLAM/multiprocess/tracker.py``).  Two paths, chosen as in JAX (:189):

* fused (gt pose, or pure ICP without the pose backend): each frame is one
  preprocess -> pyramids -> model-depth fusion -> coarse-to-fine GN solve ->
  failure gate -> world lift chain (``_tracking_fused`` :354), with one
  device-to-host fetch of the pose; with ``loop_closure_pure_icp`` the
  loop closer relocalizes after a hard failure and its closures relax the
  history on the host (``relax_pose_graph``);
* staged (``use_orb_backend``, the TUM and "ours" operating points): the
  frame is preprocessed, its pyramids built, the ICP pose solved and
  fetched, then the host-side pose backend refines it (or tracks features
  alone when ICP hard-fails) and the loop closer observes every
  ``loop_check_every``-th frame (``tracking`` :283).

The pose backend is the native one built from ``csrc/pose_backend.cc``
unless the caller passes another (the tests' fakes).  It sees the frame as
``(image * 255).astype(uint8)`` and ``(depth * depth_scale).astype(uint16)``
of the camera's float32 host arrays, as in JAX, so no frame crosses back
from the device for it.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from .. import setup_device
from ..data.camera import Camera
from ..ops import preprocess
from ..ops.icp import (IcpTracker, build_icp_pyramids, fuse_model_depth,
                       icp_solve_all_levels)
from ..utils import perf
from ..utils import traj as traj_utils
from ..utils.general import require_device
from .loop_closure import LoopCloser
from .pose_backend import create_backend, relax_pose_graph


def preprocess_frame(depth: torch.Tensor, color: torch.Tensor, K: torch.Tensor,
                     min_depth: float, max_depth: float,
                     confidence_thresh: float, use_filter: bool):
    """Per-frame preprocessing (``preprocess_frame`` :34, reference
    tracker.py:97-159): optional bilateral filter, depth-range gate,
    vertex / normal / confidence maps, low-confidence invalidation."""
    d = depth[..., 0] if depth.ndim == 3 else depth
    if use_filter:
        with perf.span("track.filter"):
            d = preprocess.bilateral_filter(d, 5, 2.0, 2.0)
    d = torch.where((d > min_depth) & (d < max_depth), d, 0.0)
    vertex_c = preprocess.compute_vertex_map(d, K)
    normal_c = preprocess.compute_normal_map(vertex_c)
    confidence = preprocess.compute_confidence_map(normal_c, K)
    invalid = torch.all(normal_c == 0, dim=-1) | (confidence[..., 0] < confidence_thresh)
    return {
        "depth_map": torch.where(invalid, 0.0, d)[..., None],
        "color_map": color,
        "normal_map_c": torch.where(invalid[..., None], 0.0, normal_c),
        "vertex_map_c": torch.where(invalid[..., None], 0.0, vertex_c),
        "confidence_map": torch.where(invalid[..., None], 0.0, confidence),
        "invalid_confidence_mask": invalid,
    }


def lift_to_world(vertex_c: torch.Tensor, normal_c: torch.Tensor,
                  c2w: torch.Tensor):
    """Camera-space vertex / normal maps -> world space (``lift_to_world``
    :64)."""
    rot_only = torch.eye(4, device=c2w.device)
    rot_only[:3, :3] = c2w[:3, :3]
    return (preprocess.transform_map(vertex_c, c2w),
            preprocess.transform_map(normal_c, rot_only))


def _lift(fm: dict, c2w: torch.Tensor) -> dict:
    fm["vertex_map_w"], fm["normal_map_w"] = lift_to_world(
        fm["vertex_map_c"], fm["normal_map_c"], c2w)
    return fm


def preprocess_and_lift(depth, color, K, c2w, min_depth, max_depth,
                        confidence_thresh, use_filter):
    """Preprocess + world lift for a pose known up front (``:79``)."""
    fm = preprocess_frame(depth, color, K, min_depth, max_depth,
                          confidence_thresh, use_filter)
    return _lift(fm, c2w)


def _upload(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# ICP-failure gate thresholds (``tracker.py:89-90``)
_GATE_DELTA_M = 0.01
_GATE_COS = float(np.cos(np.deg2rad(1.0)))


def fused_icp_track_step(depth, color, K, t0_depth, render_depth, render_normal,
                         frame_normal_w, prev_c2w, last_rel, prior_valid: bool,
                         *, min_depth, max_depth, confidence_thresh, use_filter,
                         use_model, use_motion_model, downscales, iters,
                         association, levels, damping, distance_threshold,
                         normal_threshold, sample_distance_threshold,
                         sample_normal_threshold, fail_threshold):
    """One ICP-tracked frame (``fused_icp_track_step`` :98): preprocess ->
    current pyramids -> model-depth fusion -> target pyramids -> GN solve ->
    failure gate -> pose composition -> world lift.

    Returns (frame_map, c2w, pose_used, new_last_rel, p2p, success)."""
    fm = preprocess_frame(depth, color, K, min_depth, max_depth,
                          confidence_thresh, use_filter)
    v1, n1 = build_icp_pyramids(fm["depth_map"], K, levels)
    if use_model:
        t0 = fuse_model_depth(render_depth, t0_depth, render_normal,
                              frame_normal_w, sample_distance_threshold,
                              sample_normal_threshold)
    else:
        t0 = t0_depth
    v0, n0 = build_icp_pyramids(t0, K, levels)

    pose_init = (last_rel if use_motion_model
                 else torch.eye(4, device=depth.device))
    pose10, p2p = icp_solve_all_levels(
        pose_init, v1, v0, n1, n0, K, downscales, iters, damping,
        distance_threshold, normal_threshold, association)
    success = p2p <= fail_threshold

    if use_motion_model:
        delta = torch.linalg.norm(pose10[:3, 3] - last_rel[:3, 3])
        cos_ang = torch.clamp(
            (torch.trace(pose10[:3, :3].T @ last_rel[:3, :3]) - 1.0) / 2.0,
            -1.0, 1.0)
        # with no trusted prior yet (first ICP frame) accept the solve
        coast = (~success) & prior_valid & (
            (delta > _GATE_DELTA_M) | (cos_ang < _GATE_COS))
        pose_used = torch.where(coast, last_rel, pose10)
        new_last_rel = pose_used
        success = ~coast
    else:
        pose_used = pose10
        new_last_rel = torch.where(success, pose10,
                                   torch.eye(4, device=pose10.device))
    c2w = prev_c2w @ pose_used
    return _lift(fm, c2w), c2w, pose_used, new_last_rel, p2p, success


class Tracker:
    """The tracker on ``device`` (CUDA unless the caller asks for the CPU);
    ``orb_backend`` replaces the native pose backend (tests pass fakes, and
    then initialize it themselves, as the JAX tests do)."""

    def __init__(self, args, device="cuda", orb_backend=None):
        self.device = setup_device(require_device(device))
        self.use_gt_pose = bool(args.use_gt_pose)
        self.min_depth = float(args.min_depth)
        self.max_depth = float(args.max_depth)
        self.depth_filter = bool(args.depth_filter)
        self.invalid_confidence_thresh = float(args.invalid_confidence_thresh)

        self.icp = IcpTracker(args)
        self.status = defaultdict(bool)
        self.pose_gt = []
        self.pose_es = []
        self.timestamps = []
        self.K = None
        self.curr_frame: Dict = {}

        self.use_orb_backend = bool(args.use_orb_backend)
        self.orb_useicp = bool(getattr(args, "orb_useicp", True))
        self.orb_backend = orb_backend
        if self.use_orb_backend and self.orb_backend is None:
            self.orb_backend = create_backend(args)

        # the backend path stays staged: its pose decision crosses to the
        # host mid-frame (:186-189)
        self.fused = not (self.use_orb_backend and not self.use_gt_pose)

        # loop detection + ICP verification (:191-208): with the backend it
        # feeds the backend's pose graph; the fused pure-ICP path opts in
        # with loop_closure_pure_icp (an extension beyond the reference,
        # whose pure-ICP configs have no closure) and relaxes on the host
        self.loop_closer = None
        lc_flag = bool(getattr(args, "use_loop_closure", True))
        if self.fused:
            enable_lc = lc_flag and bool(
                getattr(args, "loop_closure_pure_icp", False)) \
                and not self.use_gt_pose
        else:
            enable_lc = lc_flag
        if enable_lc:
            self.loop_closer = LoopCloser(args, self.device)
        self._loops = []                 # fused-path pose-graph constraints
        self._corrected_poses = None     # pending relaxed history for mapper
        self._backend_camera_set = False
        self._prev_depth = None          # previous frame's filtered depth
        self._model_feedback = None      # (render_d, frame_d, render_n, frame_n)
        self._last_rel = None
        self._prev_c2w = np.eye(4, dtype=np.float32)
        self._frame_count = 0

    def _tensor(self, x) -> torch.Tensor:
        """A float32 device copy of a host array: a pageable upload, one
        wait for the stream."""
        with perf.span("track.tensor_upload"):
            return _upload(x, self.device)

    # ------------------------------------------------------------------
    def map_preprocess(self, frame: Camera, frame_id: int) -> Dict:
        """Start the frame (``map_preprocess`` :220).  The fused path defers
        all device work to :meth:`tracking`; the staged one preprocesses
        here and builds the current pyramids."""
        with perf.span("track.preprocess"):
            return self._map_preprocess(frame, frame_id)

    def _map_preprocess(self, frame: Camera, frame_id: int) -> Dict:
        if self.K is None:
            self.K = self._tensor(frame.intrinsic)
        if self.use_orb_backend and not self._backend_camera_set:
            # intrinsics + raw-depth scale enable the backend's feature
            # tracking
            set_cam = getattr(self.orb_backend, "set_camera", None)
            if set_cam is not None:
                set_cam(np.asarray(frame.intrinsic), frame.image_width,
                        frame.image_height, frame.depth_scale)
            self._backend_camera_set = True
        self.curr_frame = {"frame_id": frame_id, "timestamp": frame.timestamp,
                           "pose_gt": frame.pose_gt, "color_u8": None,
                           "depth_u16": None}
        if self.use_orb_backend:
            # the backend consumes raw sensor units (metres * depth_scale)
            self.curr_frame["color_u8"] = (np.asarray(frame.image) * 255).astype(np.uint8)
            self.curr_frame["depth_u16"] = (
                np.asarray(frame.depth[..., 0]) * frame.depth_scale
            ).astype(np.uint16)
        if self.fused:
            return {"time": frame_id}
        frame_map = preprocess_frame(
            self._tensor(frame.depth), self._tensor(frame.image), self.K,
            self.min_depth, self.max_depth, self.invalid_confidence_thresh,
            self.depth_filter)
        frame_map["time"] = frame_id
        self.icp.update_curr_status(frame_map["depth_map"], self.K)
        return frame_map

    # ------------------------------------------------------------------
    def _refine_with_backend(self, pose_t1_t0: np.ndarray, icp_ok: bool) -> np.ndarray:
        """Seed the backend with the ICP relative pose, or track features
        alone on an ICP failure (``_refine_with_backend`` :259, reference
        tracker.py:225-244); adopt the backend's refreshed tail."""
        if icp_ok and self.orb_useicp:
            self.orb_backend.track_with_icp_pose(
                self.curr_frame["color_u8"], self.curr_frame["depth_u16"],
                pose_t1_t0.astype(np.float32), self.curr_frame["timestamp"])
        else:
            self.orb_backend.track_with_orb_feature(
                self.curr_frame["color_u8"], self.curr_frame["depth_u16"],
                self.curr_frame["timestamp"])
        rows = self.orb_backend.get_trajectory_points()
        # the windowed refinement may have moved the recent poses too: adopt
        # the refreshed tail (up to 8) so ATE and the exports see it
        tail_n = min(len(self.pose_es), 8)
        if tail_n:
            tail, _ = convert_poses(rows[-(tail_n + 1):-1])
            for k, p in enumerate(tail):
                self.pose_es[len(self.pose_es) - len(tail) + k] = p
        poses, _ = convert_poses(rows[-1:])
        return poses[-1]

    def tracking(self, frame: Camera, frame_map: Dict) -> bool:
        """Track one frame and fill ``frame_map`` with its world-space maps
        (``tracking`` :283)."""
        with perf.span("track.frame"):
            self.pose_gt.append(np.asarray(self.curr_frame["pose_gt"]))
            self.timestamps.append(self.curr_frame["timestamp"])
            if self.fused:
                return self._tracking_fused(frame, frame_map)
            return self._tracking_staged(frame, frame_map)

    def _tracking_staged(self, frame: Camera, frame_map: Dict) -> bool:
        """The staged path: ICP solve, pose backend, loop check."""
        success = True
        if self.use_gt_pose:
            pose_t1_w = self.pose_gt[-1]
        elif not self.status["initialized"]:
            if self.use_orb_backend:
                with perf.span("track.backend"):
                    self.orb_backend.process_image_rgbd(
                        self.curr_frame["color_u8"],
                        self.curr_frame["depth_u16"],
                        self.curr_frame["timestamp"])
            self.status["initialized"] = True
            pose_t1_w = np.eye(4)
        else:
            # success=False only on a HARD failure (the solve jumped away
            # from the motion model and the residual test fired)
            with perf.span("track.icp"):
                pose_t1_t0, success = self.icp.predict_pose()
            if not success and self.loop_closer is not None:
                reloc = self._relocalize(
                    self.pose_es[-1] @ np.asarray(pose_t1_t0),
                    frame_map["depth_map"], frame)
                if reloc is not None:
                    pose_t1_t0 = np.linalg.inv(self.pose_es[-1]) @ reloc
                    self.icp.reset_prior(pose_t1_t0)
                    success = True
            if self.use_orb_backend:
                with perf.span("track.backend"):
                    pose_t1_w = self._refine_with_backend(pose_t1_t0, success)
            else:
                pose_t1_w = self.pose_es[-1] @ pose_t1_t0

        self.icp.move_last_status()
        self.pose_es.append(np.asarray(pose_t1_w))

        loop = self._observe(pose_t1_w, frame_map["depth_map"], frame)
        if loop is not None:
            self.orb_backend.add_loop_constraint(*loop)
            # adopt the relaxed history, this frame's pose included
            corrected, _ = convert_poses(
                self.orb_backend.get_trajectory_points())
            self._close_loop(corrected if len(corrected) == len(self.pose_es)
                             else None)
            pose_t1_w = self.pose_es[-1]

        frame.update_pose(pose_t1_w)
        frame_map["vertex_map_w"], frame_map["normal_map_w"] = lift_to_world(
            frame_map["vertex_map_c"], frame_map["normal_map_c"],
            self._tensor(frame.c2w))
        return success

    def _tracking_fused(self, frame: Camera, frame_map: Dict) -> bool:
        """gt / pure-ICP tracking, one chain per frame (``_tracking_fused``
        :354)."""
        with perf.span("track.upload"):
            depth = _upload(frame.depth, self.device)
            color = _upload(frame.image, self.device)
        icp = self.icp
        success = True
        if self.use_gt_pose or not self.status["initialized"]:
            pose_t1_w = (self.pose_gt[-1] if self.use_gt_pose
                         else np.eye(4, dtype=np.float32))
            fm = preprocess_and_lift(
                depth, color, self.K, self._tensor(pose_t1_w),
                self.min_depth, self.max_depth,
                self.invalid_confidence_thresh, self.depth_filter)
            self.status["initialized"] = True
        else:
            self._frame_count += 1
            feedback = self._model_feedback
            use_model = (icp.use_model_depth and feedback is not None
                         and self._frame_count >= icp.warmup_frames)
            if use_model:
                render_d, t0_depth, render_n, frame_n = feedback
            else:
                t0_depth = self._prev_depth
                zero3 = torch.zeros(t0_depth.shape[:2] + (3,), device=self.device)
                render_d, render_n, frame_n = t0_depth, zero3, zero3
            if self._last_rel is None:
                self._last_rel = torch.eye(4, device=self.device)
            with perf.span("track.dispatch"):
                fm, c2w, _, self._last_rel, _, ok = fused_icp_track_step(
                    depth, color, self.K, t0_depth, render_d, render_n, frame_n,
                    self._tensor(self._prev_c2w), self._last_rel,
                    self._frame_count >= 2,
                    min_depth=self.min_depth, max_depth=self.max_depth,
                    confidence_thresh=self.invalid_confidence_thresh,
                    use_filter=self.depth_filter, use_model=use_model,
                    use_motion_model=icp.use_motion_model,
                    downscales=tuple(icp.downscales), iters=tuple(icp.iters),
                    association=icp.association, levels=icp.levels,
                    damping=icp.damping,
                    distance_threshold=icp.distance_threshold,
                    normal_threshold=icp.normal_threshold,
                    sample_distance_threshold=icp.sample_distance_threshold,
                    sample_normal_threshold=icp.sample_normal_threshold,
                    fail_threshold=icp.fail_threshold)
            # the one per-frame device->host fetch: pose + success
            with perf.span("track.pose_fetch"):
                host = torch.cat([c2w.reshape(-1),
                                  ok.reshape(1).to(c2w.dtype)]).cpu()
            pose_t1_w = host[:16].reshape(4, 4).numpy()
            success = bool(host[16])
            if not success and self.loop_closer is not None:
                reloc = self._relocalize(np.asarray(pose_t1_w, np.float64),
                                         fm["depth_map"], frame)
                if reloc is not None:
                    pose_t1_w = np.asarray(reloc, np.float32)
                    rel = np.linalg.inv(self._prev_c2w) @ pose_t1_w
                    self._last_rel = self._tensor(rel)
                    fm = _lift(fm, self._tensor(pose_t1_w))
                    success = True

        self._prev_depth = fm["depth_map"]
        self._model_feedback = None
        fm["time"] = frame_map.get("time", self.curr_frame["frame_id"])
        frame_map.update(fm)
        self.pose_es.append(np.asarray(pose_t1_w))

        loop = self._observe(np.asarray(pose_t1_w, np.float64),
                             fm["depth_map"], frame)
        if loop is not None:
            i, j, T_ij = loop
            self._loops.append((i, j, np.asarray(T_ij, np.float64), 1.0))
            self._close_loop([np.asarray(p) for p in
                              relax_pose_graph(self.pose_es, self._loops)])
            pose_t1_w = np.asarray(self.pose_es[-1], np.float32)
            # hand the relaxed history to the mapper (update_poses)
            self._corrected_poses = list(self.pose_es)
            frame_map.update(_lift(fm, self._tensor(pose_t1_w)))

        self._prev_c2w = np.asarray(pose_t1_w, np.float32)
        frame.update_pose(np.asarray(pose_t1_w, np.float64))
        return success

    def _relocalize(self, guess, depth_map, frame: Camera):
        """The world pose the loop closer finds from ``guess`` after a hard
        failure (the reference's ORB-SLAM2 relocalization), or None."""
        with perf.span("track.loop_check"):
            reloc = self.loop_closer.relocalize(
                self.curr_frame["frame_id"], guess, depth_map, self.K,
                color_map=frame.image)
        if reloc is not None:
            self.status["relocalized"] += 1
        return reloc

    def _observe(self, pose_t1_w, depth_map, frame: Camera):
        """The loop ``(i, j, T_ij)`` closed at this frame, or None."""
        if self.loop_closer is None:   # none on ground-truth poses either
            return None
        with perf.span("track.loop_check"):
            return self.loop_closer.observe(
                self.curr_frame["frame_id"], pose_t1_w, depth_map, self.K,
                color_map=frame.image)

    def _close_loop(self, corrected) -> None:
        """Adopt the relaxed history ``corrected`` (None: keep it) and
        re-anchor the store, or a later relocalize would bring back the
        drift this closure removed."""
        if corrected is not None:
            self.pose_es = corrected
            self.loop_closer.update_poses(corrected)
        self.status["loops_closed"] += 1

    # ------------------------------------------------------------------
    def update_last_status(self, frame, render_depth, frame_depth,
                           render_normal, frame_normal) -> None:
        """Feed the mapper's model render back into the next frame's ICP
        target (frame-to-model tracking, reference slam.py:83-89): stashed
        for the fused path's next chain, fused now on the staged path."""
        if self.fused:
            self._model_feedback = (render_depth, frame_depth, render_normal,
                                    frame_normal)
            return
        self.icp.update_last_status(render_depth, frame_depth, render_normal,
                                    frame_normal)

    def get_new_poses(self):
        """Refined pose history for the mapper (``get_new_poses`` :470): the
        backend's trajectory every frame on the staged backend path; on the
        fused path the relaxed history once after a closure; else None."""
        if self.use_orb_backend and not self.use_gt_pose:
            poses, _ = convert_poses(self.orb_backend.get_trajectory_points())
            return poses
        if self._corrected_poses is not None:
            poses, self._corrected_poses = self._corrected_poses, None
            return poses
        return None

    # ------------------------------------------------------------------
    def save_invalid_tracking(self, path: str, threshold: float = 0.15) -> bool:
        """Dump the staged path's ICP pyramids when the estimated pose
        drifted more than ``threshold`` metres from ground truth
        (``save_invalid_tracking`` :481, reference tracker.py:76-95)."""
        if not self.pose_es or not self.pose_gt:
            return False
        err = np.linalg.norm(self.pose_es[-1][:3, 3] - self.pose_gt[-1][:3, 3])
        if err <= threshold:
            return False
        os.makedirs(path, exist_ok=True)
        payload = {}
        for name, pyr in (("vertex_t0", self.icp.vertex_t0),
                          ("vertex_t1", self.icp.vertex_t1),
                          ("normal_t0", self.icp.normal_t0),
                          ("normal_t1", self.icp.normal_t1)):
            for lvl, arr in enumerate(pyr or ()):
                payload[f"{name}_l{lvl}"] = arr.cpu().numpy()
        np.savez_compressed(
            os.path.join(path, f"invalid_tracking_{len(self.pose_es)}.npz"),
            **payload)
        return True

    def eval_ate(self, frame_id: int = -1) -> float:
        n = len(self.pose_es) if frame_id == -1 else frame_id
        return traj_utils.ate_rmse(np.stack(self.pose_gt[:n])[:, :3, 3],
                                   np.stack(self.pose_es[:n])[:, :3, 3])

    def save_traj(self, save_path: str) -> float:
        """Write ``save_traj/``: pose_es.npy, pose_gt.npy, traj_tum.txt and
        (with matplotlib) the ATE plots; returns the ATE in cm
        (``save_traj`` :509).  With the backend, its trajectory is the
        estimate, and the backend shuts down."""
        save_dir = os.path.join(save_path, "save_traj")
        if not self.use_gt_pose and self.use_orb_backend:
            self.pose_es, _ = convert_poses(self.orb_backend.get_trajectory_points())
        traj_utils.save_traj_npy(save_dir, self.pose_es, self.pose_gt)
        ate = traj_utils.save_ate_plots(save_dir, self.pose_es, self.pose_gt)
        traj_utils.save_traj_tum(
            os.path.join(save_dir, "traj_tum.txt"), self.pose_es, self.timestamps)
        if self.use_orb_backend:
            self.orb_backend.shutdown()
        return ate


def convert_poses(rows):
    """Backend trajectory rows (stamp, r00..r22 | t interleaved) -> 4x4
    poses and stamps (``convert_poses`` :522, reference tracker.py:16-26)."""
    poses, stamps = [], []
    for row in rows:
        stamp, r00, r01, r02, t0, r10, r11, r12, t1, r20, r21, r22, t2 = row
        pose = np.eye(4)
        pose[:3, :3] = [[r00, r01, r02], [r10, r11, r12], [r20, r21, r22]]
        pose[:3, 3] = [t0, t1, t2]
        poses.append(pose)
        stamps.append(stamp)
    return poses, stamps
