"""Disc-shaped densification of the gaussian map into a point cloud.

Port of ``rtgslam_tpu/models/densify.py`` (reference
``gaussian_pointcloud.py:53-116`` ``densify``, driven by the
``pcd_densify`` flag, slam.py:146-150).  Same sampling scheme, vectorized
numpy: for each gaussian, ``levels`` rings x ``circle_num`` angles x
``sigma`` radial bands on the plane spanned by the two largest axes.
"""

from __future__ import annotations

import numpy as np

from ..utils.ply import write_ply


def _quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """``utils/geometry.py::quat_to_rotmat`` in float32 numpy: the norm's
    sum runs in index order, as the JAX package's does, so the densified
    points round as the JAX package rounds them (a pairwise sum moves some
    by an ulp)."""
    q = q / np.sqrt(np.sum(q * q, axis=-1, keepdims=True) + np.float32(1e-16))
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def densify_points(xyz: np.ndarray, scaling_log: np.ndarray, rotation: np.ndarray,
                   sigma: int = 1, circle_num: int = 30, levels: int = 5):
    """Returns (points [N*S, 3], normals [N*S, 3]) sampling each disc."""
    scales = np.exp(scaling_log)
    R = _quat_to_rotmat(np.asarray(rotation, np.float32))  # [N, 3, 3] columns = axes
    order = np.argsort(scales, axis=1)                     # ascending
    n = xyz.shape[0]
    idx = np.arange(n)
    normal_axis = order[:, 0]
    a_axis, b_axis = order[:, 1], order[:, 2]
    normal = R[idx, :, normal_axis]
    a_dir = R[idx, :, a_axis]
    b_dir = R[idx, :, b_axis]
    a_len = scales[idx, a_axis]
    b_len = scales[idx, b_axis]

    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 2 * np.pi, circle_num)
    ring = (np.arange(levels) + 0.5) / levels              # radial fractions
    band = np.arange(sigma) + 1.0
    rr = (ring[None, :] * band[:, None]).reshape(-1)       # [sigma*levels]
    ca = np.cos(theta)[None, :] * rr[:, None]              # [S_r, circle]
    sb = np.sin(theta)[None, :] * rr[:, None]
    ca = ca.reshape(-1)                                    # [S]
    sb = sb.reshape(-1)

    pts = (xyz[:, None, :]
           + a_dir[:, None, :] * (a_len[:, None] * ca)[:, :, None]
           + b_dir[:, None, :] * (b_len[:, None] * sb)[:, :, None])
    nrm = np.repeat(normal[:, None, :], len(ca), axis=1)
    return pts.reshape(-1, 3).astype(np.float32), nrm.reshape(-1, 3).astype(np.float32)


def save_densified_ply(path: str, xyz, scaling_log, rotation,
                       sigma: int = 1, circle_num: int = 30, levels: int = 5):
    pts, nrm = densify_points(xyz, scaling_log, rotation, sigma, circle_num, levels)
    write_ply(path, {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "nx": nrm[:, 0], "ny": nrm[:, 1], "nz": nrm[:, 2],
    })
    return pts.shape[0]
