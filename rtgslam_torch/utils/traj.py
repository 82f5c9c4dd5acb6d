"""Trajectory evaluation and export: Horn-aligned ATE, TUM format.

Numpy copy of ``rtgslam_tpu/utils/traj.py`` (reference
``SLAM/utils.py:455-501``, ``tracker.py:311-378``), which the JAX package
reaches only through a module that imports JAX.  ATE is the Horn-aligned
translational RMSE of the estimated trajectory against ground truth, in
centimetres.  ``save_ate_plots`` draws only where matplotlib is installed;
the ATE it returns never depends on it.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

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


def ate_curve(pose_es: Sequence[np.ndarray], pose_gt: Sequence[np.ndarray]) -> np.ndarray:
    """ATE after each frame prefix (reference ``tracker.py:297-302``)."""
    es = np.stack(pose_es)[:, :3, 3]
    gt = np.stack(pose_gt)[:, :3, 3]
    out = []
    for i in range(1, len(gt) + 1):
        if i < 2:
            out.append(float(np.linalg.norm(es[0] - gt[0]) * 100))
        else:
            out.append(ate_rmse(es[:i], gt[:i]))
    return np.array(out)


def _pose_to_tum_line(stamp: float, pose: np.ndarray) -> str:
    from scipy.spatial.transform import Rotation as R

    t = pose[:3, 3]
    q = R.from_matrix(pose[:3, :3]).as_quat()  # (x, y, z, w)
    vals = [stamp, *t.tolist(), *q.tolist()]
    return " ".join(str(v) for v in vals)


def save_traj_tum(path: str, poses: Sequence[np.ndarray], stamps: Sequence[float]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for stamp, pose in zip(stamps, poses):
            f.write(_pose_to_tum_line(stamp, pose) + " \n")


def save_traj_npy(save_dir: str, pose_es: Sequence[np.ndarray], pose_gt: Sequence[np.ndarray]) -> None:
    os.makedirs(save_dir, exist_ok=True)
    np.save(os.path.join(save_dir, "pose_es.npy"), np.stack(pose_es))
    np.save(os.path.join(save_dir, "pose_gt.npy"), np.stack(pose_gt))


def save_ate_plots(save_dir: str, pose_es: Sequence[np.ndarray], pose_gt: Sequence[np.ndarray]) -> float:
    """Save ate.png + traj_xy.jpg like the reference where matplotlib is
    installed, and return the final ATE either way."""
    os.makedirs(save_dir, exist_ok=True)
    ates = ate_curve(pose_es, pose_gt)
    try:
        import matplotlib
    except ImportError:
        print("[traj] matplotlib is not installed: ate.png and traj_xy.jpg "
              "are not drawn")
        return float(ates[-1])

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.plot(range(len(ates)), ates)
    plt.ylim(0, max(ates) + 0.1)
    plt.title(f"ate:{ates[-1]}")
    plt.savefig(os.path.join(save_dir, "ate.png"))
    plt.close()

    es = np.stack(pose_es)
    gt = np.stack(pose_gt)
    plt.figure()
    plt.plot(es[:, 0, 3], es[:, 1, 3])
    plt.plot(gt[:, 0, 3], gt[:, 1, 3])
    plt.legend(["es", "gt"])
    plt.savefig(os.path.join(save_dir, "traj_xy.jpg"))
    plt.close()
    return float(ates[-1])


def associate_timestamps(
    stamps_a: Sequence[float],
    stamps_b: Sequence[float],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[int, int]]:
    """Greedy closest-timestamp association (reference ``scripts/associate.py``)."""
    candidates = [
        (abs(a + offset - b), i, j)
        for i, a in enumerate(stamps_a)
        for j, b in enumerate(stamps_b)
        if abs(a + offset - b) < max_difference
    ]
    candidates.sort()
    used_a, used_b, matches = set(), set(), []
    for _, i, j in candidates:
        if i not in used_a and j not in used_b:
            used_a.add(i)
            used_b.add(j)
            matches.append((i, j))
    matches.sort()
    return matches
