"""Real spherical harmonics for view-dependent Gaussian color.

Port of ``rtgslam_tpu/utils/sh.py``: the hard-coded real-SH basis up to
degree 3, coefficient-major layout [..., (deg+1)^2, 3] (f_dc then f_rest).
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB in [0,1] -> DC SH coefficient (reference ``RGB2SH``)."""
    return (rgb - 0.5) / C0


def sh_to_rgb(sh: torch.Tensor) -> torch.Tensor:
    """DC SH coefficient -> RGB (``sh_to_rgb`` :27, reference ``SH2RGB``)."""
    return sh * C0 + 0.5


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis_cols(degree: int, x, y, z):
    """The (degree+1)^2 real-SH basis values as a list of [...] columns of
    the unit view direction (``sh.py::sh_basis_cols`` :35)."""
    basis = [torch.full_like(x, C0)]
    if degree >= 1:
        basis += [-C1 * y, C1 * z, -C1 * x]
        if degree >= 2:
            xx, yy, zz = x * x, y * y, z * z
            basis += [
                C2[0] * x * y, C2[1] * y * z, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * x * z, C2[4] * (xx - yy),
            ]
            if degree >= 3:
                basis += [
                    C3[0] * y * (3 * xx - yy), C3[1] * x * y * z,
                    C3[2] * y * (4 * zz - xx - yy),
                    C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                    C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                    C3[6] * x * (xx - 3 * yy),
                ]
    return basis


def eval_sh_flat(degree: int, sh_flat: torch.Tensor, x, y, z):
    """Column-form SH evaluation: ``sh_flat`` [..., 3*K] coefficient-major
    (k*3 + channel); returns (r, g, b) [...] columns (``eval_sh_flat`` :63)."""
    basis = sh_basis_cols(degree, x, y, z)
    out = []
    for ch in range(3):
        acc = basis[0] * sh_flat[..., ch]
        for kk in range(1, len(basis)):
            acc = acc + basis[kk] * sh_flat[..., 3 * kk + ch]
        out.append(acc)
    return tuple(out)



def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH colors (``eval_sh`` :83): ``sh`` [..., K, 3] with K >=
    (degree+1)^2, ``dirs`` [..., 3] unit view directions (gaussian centre
    minus camera).  Returns [..., 3] linear colour, before the +0.5 shift
    and the clamp; the terms add in the JAX package's order."""
    result = C0 * sh[..., 0, :]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        result = (
            result
            - C1 * y * sh[..., 1, :]
            + C1 * z * sh[..., 2, :]
            - C1 * x * sh[..., 3, :]
        )
        if degree >= 2:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + C2[0] * xy * sh[..., 4, :]
                + C2[1] * yz * sh[..., 5, :]
                + C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + C2[3] * xz * sh[..., 7, :]
                + C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if degree >= 3:
                result = (
                    result
                    + C3[0] * y * (3 * xx - yy) * sh[..., 9, :]
                    + C3[1] * xy * z * sh[..., 10, :]
                    + C3[2] * y * (4 * zz - xx - yy) * sh[..., 11, :]
                    + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[..., 12, :]
                    + C3[4] * x * (4 * zz - xx - yy) * sh[..., 13, :]
                    + C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + C3[6] * x * (xx - 3 * yy) * sh[..., 15, :]
                )
    return result
