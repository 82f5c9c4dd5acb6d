"""Geometry primitives: quaternions, rotations, SE(3), camera matrices.

Port of ``rtgslam_tpu/utils/geometry.py``.  Conventions follow the
reference so artifacts interoperate: quaternions (w, x, y, z), stored
unnormalized and normalized on use; ``exp_se3`` takes the twist order
[rot, trans] with the left Jacobian on the translation.  The camera-matrix
helpers at the bottom are host-side numpy, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Quaternions / rotations
# ---------------------------------------------------------------------------

def normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """v / sqrt(|v|^2 + eps^2): finite at v = 0 (``normalize`` :26)."""
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps * eps)


def quat_to_rotmat_cols(q: torch.Tensor):
    """Quaternion (w,x,y,z) -> the 9 rotation entries as [...] columns,
    row-major r00..r22 (``quat_to_rotmat_cols`` :33)."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    )


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w,x,y,z) -> rotation matrix [..., 3, 3]."""
    return torch.stack(quat_to_rotmat_cols(q), dim=-1).reshape(
        q.shape[:-1] + (3, 3))


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """axis [..., 3] (unit), angle [..., 1] -> quaternion (w,x,y,z)."""
    half = angle * 0.5
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_align_z_to(normal: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating +z onto ``normal`` (``quat_align_z_to`` :80,
    reference ``SLAM/utils.py:216-221``); identity / 180 deg about x where
    the normal is parallel to +-z."""
    z = torch.zeros_like(normal)
    z[..., 2] = 1.0
    cross = torch.linalg.cross(z, normal, dim=-1)
    axis = normalize(cross)
    cosang = torch.clamp(torch.sum(z * normal, dim=-1, keepdim=True), -1.0, 1.0)
    q = quat_from_axis_angle(axis, torch.arccos(cosang))
    near_parallel = torch.linalg.norm(cross, dim=-1, keepdim=True) < 1e-6
    one, zero = torch.ones_like(cosang), torch.zeros_like(cosang)
    q_id = torch.cat([one, zero, zero, zero], dim=-1)
    q_pi = torch.cat([zero, one, zero, zero], dim=-1)
    fallback = torch.where(cosang < 0, q_pi, q_id)
    return torch.where(near_parallel, fallback, q)


def build_covariance(scaling: torch.Tensor, rotation_q: torch.Tensor) -> torch.Tensor:
    """3D covariance R S S^T R^T from per-gaussian scales [..., 3] and
    quaternions [..., 4] (``build_covariance`` :101)."""
    R = quat_to_rotmat(rotation_q)
    RS = R * scaling[..., None, :]
    return RS @ RS.transpose(-1, -2)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    zero = torch.zeros_like(w[..., 0])
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack([
        torch.stack([zero, -w2, w1], dim=-1),
        torch.stack([w2, zero, -w0], dim=-1),
        torch.stack([-w1, w0, zero], dim=-1),
    ], dim=-2)


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [rot(3), trans(3)] -> 4x4 transform (``exp_se3`` :126,
    reference ``SLAM/icp.py:271-310``)."""
    w, v = xi[:3], xi[3:6]
    theta = torch.linalg.norm(w)
    w_hat = skew(w)
    w_hat2 = w_hat @ w_hat
    eps = 1e-8
    safe = torch.clamp(theta, min=eps)
    sin_t, cos_t = torch.sin(safe), torch.cos(safe)
    A = sin_t / safe
    B = (1.0 - cos_t) / (safe * safe)
    C = (safe - sin_t) / (safe ** 3)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    small = theta <= eps
    R = torch.where(small, eye, eye + A * w_hat + B * w_hat2)
    J = torch.where(small, eye, eye + B * w_hat + C * w_hat2)
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = J @ v
    return T


# ---------------------------------------------------------------------------
# Camera matrices (numpy, host side — poses are tiny)
# ---------------------------------------------------------------------------

def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.zeros(3), scale: float = 1.0) -> np.ndarray:
    """w2c 4x4 from colmap-style (R=c2w rotation, t=w2c translation)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.float32(np.linalg.inv(C2W))


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """GL-style perspective projection (``projection_matrix`` :174,
    reference ``getProjectionMatrix``)."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top, right = tan_y * znear, tan_x * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def rot_compare(prev_rot: np.ndarray, curr_rot: np.ndarray):
    """Angle (rad, deg) between two rotations (reference ``SLAM/utils.py:42-47``)."""
    rot_diff = prev_rot.T @ curr_rot
    cos_theta = np.clip((np.trace(rot_diff) - 1) / 2, -1.0, 1.0)
    rad = np.arccos(cos_theta)
    return rad, np.rad2deg(rad)


def trans_compare(prev_t: np.ndarray, curr_t: np.ndarray):
    diff = prev_t - curr_t
    return np.linalg.norm(diff, ord=1), np.linalg.norm(diff, ord=2)
