"""Trajectory evaluation: Horn-aligned ATE.

Numpy copy of ``rtgslam_tpu/utils/traj.py`` (``horn_align`` :16,
``ate_rmse`` :35; reference ``SLAM/utils.py:455-501``), which the JAX
package reaches only through a module that imports JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def horn_align(model: np.ndarray, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Closed-form Horn alignment of two [3, N] trajectories.

    Returns (rot, trans, per-point translational error)."""
    model_c = model - model.mean(axis=1, keepdims=True)
    data_c = data - data.mean(axis=1, keepdims=True)
    W = model_c @ data_c.T
    U, _, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(axis=1, keepdims=True) - rot @ model.mean(axis=1, keepdims=True)
    aligned = rot @ model + trans
    err = np.sqrt(np.sum((aligned - data) ** 2, axis=0))
    return rot, trans, err


def ate_rmse(pose_es: np.ndarray, pose_gt: np.ndarray) -> float:
    """ATE RMSE in cm over [N,3] (or [N,4,4]) trajectories."""
    if pose_es.ndim == 3:
        pose_es = pose_es[:, :3, 3]
    if pose_gt.ndim == 3:
        pose_gt = pose_gt[:, :3, 3]
    _, _, err = horn_align(pose_es.T, pose_gt.T)
    return float(np.sqrt(np.dot(err, err) / len(err)) * 100)
