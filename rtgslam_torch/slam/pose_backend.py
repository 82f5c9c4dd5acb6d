"""Host-side pose-refinement backend with the orbslam2 binding API.

Numpy copy of ``rtgslam_tpu/slam/pose_backend.py``.  The reference refines
ICP poses with an ORB-SLAM2 C++ backend reached through a Boost.Python
binding (call sites ``SLAM/multiprocess/tracker.py:225-260``), whose API
is:

    System(vocab_path, settings_path, sensor)
    .set_use_viewer(bool)
    .initialize(useicp)
    .process_image_rgbd(color_u8, depth_u16, timestamp)
    .track_with_icp_pose(color_u8, depth_u16, pose_t1_t0_f32, timestamp)
    .track_with_orb_feature(color_u8, depth_u16, timestamp)
    .get_trajectory_points() / .get_keyframe_points()
        -> rows (stamp, r00,r01,r02,t0, r10,r11,r12,t1, r20,r21,r22,t2)
    .shutdown()

This module holds:
  * :func:`relax_pose_graph` — the host-side pose-graph relaxation of the
    fused pure-ICP path's loop closures (the numpy twin of the native
    ``Backend::relax``);
  * :class:`FakePoseBackend` — an in-process implementation of the API that
    integrates the ICP relative poses it is fed and holds the last pose on a
    feature-track fallback.  It is a test shim: the tracker uses it only when
    a caller passes one in;
  * :func:`create_backend` — the native backend (``csrc/pose_backend.cc``,
    built with g++ at first use), or an error when it cannot be built.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _pose_to_row(stamp: float, pose: np.ndarray):
    r = pose[:3, :3]
    t = pose[:3, 3]
    return (stamp,
            r[0, 0], r[0, 1], r[0, 2], t[0],
            r[1, 0], r[1, 1], r[1, 2], t[1],
            r[2, 0], r[2, 1], r[2, 2], t[2])


def _so3_log(R: np.ndarray) -> np.ndarray:
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    s = np.sin(theta)
    k = 0.5 if abs(s) < 1e-9 else theta / (2.0 * s)
    return k * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def _so3_exp(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def relax_pose_graph(poses: List[np.ndarray], loops, iterations: int = 50):
    """Decoupled rotation / translation Gauss-Seidel pose-graph relaxation
    (``relax_pose_graph`` :69, the twin of ``Backend::relax`` in
    ``csrc/pose_backend.cc``).

    ``loops``: (i, j, T_ij, weight) with T_ij = c2w_i^-1 @ c2w_j measured.
    Odometry constraints come from the chain at entry; pose 0 is gauge-fixed.
    """
    n = len(poses)
    if n < 2 or not loops:
        return poses
    poses = [p.copy() for p in poses]
    cons = [(i, i + 1, np.linalg.inv(poses[i]) @ poses[i + 1], 1.0)
            for i in range(n - 1)]
    cons += [tuple(l) for l in loops]
    for _ in range(iterations):
        acc_w = np.zeros((n, 3))
        acc_t = np.zeros((n, 3))
        wsum = np.full(n, 1e-9)
        for (i, j, T_ij, wt) in cons:
            if not (0 <= i < n and 0 <= j < n):
                continue
            pred_j = poses[i] @ T_ij
            pred_i = poses[j] @ np.linalg.inv(T_ij)
            for idx, pred in ((j, pred_j), (i, pred_i)):
                if idx == 0:
                    continue  # gauge-fix the first pose
                delta = pred @ np.linalg.inv(poses[idx])
                acc_w[idx] += wt * _so3_log(delta[:3, :3])
                acc_t[idx] += wt * (pred[:3, 3] - poses[idx][:3, 3])
                wsum[idx] += wt
        step = 0.5
        for k in range(1, n):
            R = _so3_exp(step * acc_w[k] / wsum[k])
            upd = poses[k].copy()
            upd[:3, :3] = R @ poses[k][:3, :3]
            upd[:3, 3] = poses[k][:3, 3] + step * acc_t[k] / wsum[k]
            poses[k] = upd
    return poses


class FakePoseBackend:
    """Drop-in orbslam2.System replacement that trusts the ICP odometry
    (``FakePoseBackend`` :110)."""

    def __init__(self, vocab_path: str = "", settings_path: str = "", sensor=None):
        self._poses: List[np.ndarray] = []
        self._stamps: List[float] = []
        self._loops: List[tuple] = []
        self._keyframe_every = 10
        self._use_icp = True
        self._running = False

    # -- lifecycle ---------------------------------------------------------
    def set_use_viewer(self, flag: bool) -> None:
        pass

    def set_camera(self, K, width: int, height: int,
                   depth_scale: float = 1000.0) -> None:
        """API parity with the native backend; the fake's pose-hold needs
        no intrinsics."""
        self._camera = (np.asarray(K, np.float64), int(width), int(height),
                        float(depth_scale))

    def last_track_ok(self) -> bool:
        return False

    def last_track_inliers(self) -> int:
        return 0

    def initialize(self, useicp: bool) -> None:
        self._use_icp = useicp
        self._running = True

    def shutdown(self) -> None:
        self._running = False

    # -- tracking ----------------------------------------------------------
    def process_image_rgbd(self, color, depth, timestamp: float) -> None:
        self._poses.append(np.eye(4))
        self._stamps.append(timestamp)

    def track_with_icp_pose(self, color, depth, pose_t1_t0: np.ndarray,
                            timestamp: float) -> None:
        prev = self._poses[-1] if self._poses else np.eye(4)
        self._poses.append(prev @ np.asarray(pose_t1_t0, np.float64))
        self._stamps.append(timestamp)

    def track_with_orb_feature(self, color, depth, timestamp: float) -> None:
        prev = self._poses[-1] if self._poses else np.eye(4)
        self._poses.append(prev.copy())
        self._stamps.append(timestamp)

    # -- loop closure ------------------------------------------------------
    def add_loop_constraint(self, i: int, j: int, T_ij: np.ndarray,
                            weight: float = 1.0, iterations: int = 50) -> None:
        """Register a measured relative pose T_ij = c2w_i^-1 @ c2w_j between
        frames i and j and relax the pose graph (native twin:
        ``pb_add_loop_constraint``)."""
        self._loops.append((int(i), int(j), np.asarray(T_ij, np.float64),
                            float(weight)))
        self._poses = relax_pose_graph(self._poses, self._loops, iterations)

    # -- trajectory --------------------------------------------------------
    def get_trajectory_points(self):
        return [_pose_to_row(s, p) for s, p in zip(self._stamps, self._poses)]

    def get_keyframe_points(self):
        rows = list(zip(self._stamps, self._poses))
        return [_pose_to_row(s, p) for s, p in rows[:: self._keyframe_every]]


def create_backend(args):
    """The native backend built from the port's ``csrc/pose_backend.cc``,
    initialized (``create_backend`` :180, without its silent fallback: a
    backend that cannot be built raises)."""
    from .native_backend import NativePoseBackend

    backend = NativePoseBackend(None, args.orb_vocab_path, args.orb_settings_path)
    # windowed refinement of recent poses (the local-BA role of the
    # reference's ORB-SLAM2 backend, tracker.py:225-241); orb_window_ba:
    # False disables it
    backend.set_window_ba(getattr(args, "orb_window_ba", True))
    backend.set_use_viewer(False)
    backend.initialize(getattr(args, "orb_useicp", True))
    return backend
