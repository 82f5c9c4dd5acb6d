"""Tracking front-end: frame preprocessing + pose estimation.

Port of the fused path of ``rtgslam_tpu/slam/tracker.py``: gt-pose and
pure-ICP tracking (``_tracking_fused`` :354-454), each frame one
preprocess -> pyramids -> model-depth fusion -> coarse-to-fine GN solve ->
failure gate -> world lift chain.  The ORB backend and pure-ICP loop
closure are not ported yet: the constructor refuses them.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from .. import setup_device
from ..data.camera import Camera
from ..ops import preprocess
from ..ops.icp import (IcpTracker, build_icp_pyramids, fuse_model_depth,
                       icp_solve_all_levels)
from ..utils import traj as traj_utils


def preprocess_frame(depth: torch.Tensor, color: torch.Tensor, K: torch.Tensor,
                     min_depth: float, max_depth: float,
                     confidence_thresh: float, use_filter: bool):
    """Per-frame preprocessing (``preprocess_frame`` :34, reference
    tracker.py:97-159): optional bilateral filter, depth-range gate,
    vertex / normal / confidence maps, low-confidence invalidation."""
    d = depth[..., 0] if depth.ndim == 3 else depth
    if use_filter:
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


def _lift(fm: dict, c2w: torch.Tensor) -> dict:
    rot_only = torch.eye(4, device=c2w.device)
    rot_only[:3, :3] = c2w[:3, :3]
    fm["vertex_map_w"] = preprocess.transform_map(fm["vertex_map_c"], c2w)
    fm["normal_map_w"] = preprocess.transform_map(fm["normal_map_c"], rot_only)
    return fm


def preprocess_and_lift(depth, color, K, c2w, min_depth, max_depth,
                        confidence_thresh, use_filter):
    """Preprocess + world lift for a pose known up front (``:79``)."""
    fm = preprocess_frame(depth, color, K, min_depth, max_depth,
                          confidence_thresh, use_filter)
    return _lift(fm, c2w)


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
    """Fused gt-pose / pure-ICP tracker on ``device``."""

    def __init__(self, args, device="cpu"):
        if bool(args.use_orb_backend) and not bool(args.use_gt_pose):
            raise NotImplementedError(
                "the ORB pose backend is not ported yet")
        if (bool(getattr(args, "use_loop_closure", True))
                and bool(getattr(args, "loop_closure_pure_icp", False))
                and not bool(args.use_gt_pose)):
            raise NotImplementedError("pure-ICP loop closure is not ported yet")
        self.device = setup_device(device)
        self.use_gt_pose = bool(args.use_gt_pose)
        self.min_depth = float(args.min_depth)
        self.max_depth = float(args.max_depth)
        self.depth_filter = bool(args.depth_filter)
        self.invalid_confidence_thresh = float(args.invalid_confidence_thresh)

        self.icp = IcpTracker(args)
        self.status = defaultdict(bool)
        self.pose_gt = []
        self.pose_es = []
        self.K = None
        self._prev_depth = None       # previous frame's filtered depth
        self._model_feedback = None   # (render_d, frame_d, render_n, frame_n)
        self._last_rel = None
        self._prev_c2w = np.eye(4, dtype=np.float32)
        self._frame_count = 0
        self._frame_id = 0

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def map_preprocess(self, frame: Camera, frame_id: int) -> Dict:
        """All device work happens in :meth:`tracking`; this starts the
        frame map (``map_preprocess`` :220, fused path)."""
        if self.K is None:
            self.K = self._tensor(frame.intrinsic)
        self._frame_id = frame_id
        return {"time": frame_id}

    def tracking(self, frame: Camera, frame_map: Dict) -> bool:
        """Track one frame and fill ``frame_map`` with its world-space maps
        (``_tracking_fused`` :354)."""
        self.pose_gt.append(np.asarray(frame.pose_gt))
        depth = self._tensor(frame.depth)
        color = self._tensor(frame.image)
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
            pose_t1_w = c2w.cpu().numpy()
            success = bool(ok)

        self._prev_depth = fm["depth_map"]
        self._model_feedback = None
        fm["time"] = frame_map.get("time", self._frame_id)
        frame_map.update(fm)
        self.pose_es.append(np.asarray(pose_t1_w))
        self._prev_c2w = np.asarray(pose_t1_w, np.float32)
        frame.update_pose(np.asarray(pose_t1_w, np.float64))
        return success

    def update_last_status(self, frame, render_depth, frame_depth,
                           render_normal, frame_normal) -> None:
        """Stash the mapper's model render for the next frame's
        frame-to-model ICP target (reference slam.py:83-89)."""
        self._model_feedback = (render_depth, frame_depth, render_normal,
                                frame_normal)

    def get_new_poses(self):
        """Refined pose history for the mapper: none on the fused path
        without loop closure."""
        return None

    def eval_ate(self, frame_id: int = -1) -> float:
        n = len(self.pose_es) if frame_id == -1 else frame_id
        return traj_utils.ate_rmse(np.stack(self.pose_gt[:n])[:, :3, 3],
                                   np.stack(self.pose_es[:n])[:, :3, 3])
