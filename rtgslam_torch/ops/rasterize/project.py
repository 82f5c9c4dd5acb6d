"""EWA projection of 3D Gaussians to screen space.

Port of ``rtgslam_tpu/ops/rasterize/project.py``:
:func:`project_geometry` gives the screen-space geometry binning needs for
every slot; :func:`shade_cols` the SH color and opaque-normal gate, run on
the depth-sorted visible subset only.  :func:`shade` and :func:`project`
(a :class:`FullProjection` over the whole array) are the JAX module's
compatibility surface for tests and tools; the render path does not use
them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils import sh as sh_utils
from ...utils.geometry import quat_to_rotmat_cols

# low-pass dilation of 2D covariances (standard 3DGS EWA)
COV2D_DILATION = 0.3
DEPTH_NEAR = 0.2


class Projected(NamedTuple):
    """Per-gaussian screen-space geometry, all [P] or [P, k]."""

    mean2d: torch.Tensor   # [P, 2] pixel coordinates
    conic: torch.Tensor    # [P, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor    # [P] view-space z
    radius: torch.Tensor   # [P] screen-space 3-sigma radius (pixels)
    visible: torch.Tensor  # [P] bool


class FullProjection(NamedTuple):
    """Geometry + shading (``FullProjection`` :43)."""

    mean2d: torch.Tensor
    conic: torch.Tensor
    depth: torch.Tensor
    radius: torch.Tensor
    rgb: torch.Tensor
    opacity: torch.Tensor
    normal_elig: torch.Tensor
    visible: torch.Tensor


def project_geometry(xyz, scaling, rotation, alive, w2c, K, width: int,
                     height: int, scale_modifier: float = 1.0) -> Projected:
    """Project activated gaussians (``project_geometry`` :56).  Scalar
    columns throughout, the same float32 operation order as the JAX code."""
    R, t = w2c[:3, :3], w2c[:3, 3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    X, Y, Z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    x = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z + t[0]
    y = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z + t[1]
    z = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z + t[2]
    in_front = z > DEPTH_NEAR
    z_safe = torch.where(in_front, z, 1.0)

    mean_x = fx * x / z_safe + cx
    mean_y = fy * y / z_safe + cy

    # EWA: cov2d = J W cov3d W^T J^T with the frustum-clamped Jacobian
    tan_x, tan_y = (width / 2) / fx, (height / 2) / fy
    tx = torch.minimum(torch.maximum(x / z_safe, -1.3 * tan_x), 1.3 * tan_x) * z_safe
    ty = torch.minimum(torch.maximum(y / z_safe, -1.3 * tan_y), 1.3 * tan_y) * z_safe
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2

    q = quat_to_rotmat_cols(rotation)
    s = (scaling[..., 0] * scale_modifier, scaling[..., 1] * scale_modifier,
         scaling[..., 2] * scale_modifier)
    A = [[(R[i, 0] * q[j] + R[i, 1] * q[3 + j] + R[i, 2] * q[6 + j]) * s[j]
          for j in range(3)] for i in range(3)]
    M0 = [j00 * A[0][j] + j02 * A[2][j] for j in range(3)]
    M1 = [j11 * A[1][j] + j12 * A[2][j] for j in range(3)]
    a = M0[0] * M0[0] + M0[1] * M0[1] + M0[2] * M0[2] + COV2D_DILATION
    b = M0[0] * M1[0] + M0[1] * M1[1] + M0[2] * M1[2]
    c = M1[0] * M1[0] + M1[1] * M1[1] + M1[2] * M1[2] + COV2D_DILATION

    det = a * c - b * b
    det_ok = det > 0
    det_safe = torch.where(det_ok, det, 1.0)

    mid = 0.5 * (a + c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    on_screen = ((mean_x + radius > 0) & (mean_x - radius < width)
                 & (mean_y + radius > 0) & (mean_y - radius < height))
    visible = alive & in_front & det_ok & (radius > 0) & on_screen

    return Projected(
        mean2d=torch.stack([mean_x, mean_y], dim=-1),
        conic=torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1),
        depth=z,
        radius=torch.where(visible, radius, 0.0),
        visible=visible,
    )


def shade_cols(xyz, shs_flat, normal, campos, sh_degree: int,
               normal_threshold: float):
    """SH color + opaque-normal eligibility as [V] columns
    (``shade_cols`` :141): returns (r, g, b, normal_elig)."""
    dx = xyz[..., 0] - campos[0]
    dy = xyz[..., 1] - campos[1]
    dz = xyz[..., 2] - campos[2]
    inv = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    dx, dy, dz = dx * inv, dy * inv, dz * inv
    r, g, b = sh_utils.eval_sh_flat(sh_degree, shs_flat, dx, dy, dz)
    # torch.maximum, not clamp: at r + 0.5 == 0 it splits the gradient
    # 0.5 / 0.5 as jnp.maximum does, where clamp passes all of it
    zero = r.new_zeros(())
    r = torch.maximum(r + 0.5, zero)
    g = torch.maximum(g + 0.5, zero)
    b = torch.maximum(b + 0.5, zero)
    ndot = normal[..., 0] * dx + normal[..., 1] * dy + normal[..., 2] * dz
    return r, g, b, torch.abs(ndot) >= normal_threshold


def shade(xyz, shs, normal, campos, sh_degree: int, normal_threshold: float):
    """Stacked-output twin of :func:`shade_cols` (``shade`` :175): returns
    (rgb [P, 3], normal_elig [P])."""
    r, g, b, normal_elig = shade_cols(
        xyz, shs.reshape(shs.shape[0], -1), normal, campos, sh_degree,
        normal_threshold)
    return torch.stack([r, g, b], dim=-1), normal_elig


def project(xyz, scaling, rotation, opacity, shs, normal, alive, w2c, K,
            campos, width: int, height: int, sh_degree: int,
            normal_threshold: float,
            scale_modifier: float = 1.0) -> FullProjection:
    """Projection with shading over the whole array (``project`` :190); the
    render path shades only the sorted visible subset instead."""
    geo = project_geometry(xyz, scaling, rotation, alive, w2c, K, width,
                           height, scale_modifier)
    rgb, elig = shade(xyz, shs, normal, campos, sh_degree, normal_threshold)
    return FullProjection(
        mean2d=geo.mean2d, conic=geo.conic, depth=geo.depth,
        radius=geo.radius, rgb=rgb, opacity=opacity.reshape(-1),
        normal_elig=elig, visible=geo.visible)
