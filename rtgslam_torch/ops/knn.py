"""K-nearest-neighbour search over point sets.

Port of ``rtgslam_tpu/ops/knn.py::knn`` (:38), the stand-in for the
reference's CUDA ``distCUDA2`` and ``pytorch3d`` KNN.  Distances use the
JAX formula ``|q|^2 + |r|^2 - 2 q.r`` clamped at 0, with invalid references
at +inf (not ``torch.cdist``, whose algorithm switches with size), computed
over blocks of query rows.  The k smallest are taken by k first-minimum
passes, so equal distances go to the lowest reference index.
"""

from __future__ import annotations

import torch

# query rows per block: keeps the [rows, R] distance block near 256 MB
BLOCK_ELEMS = 1 << 26


def knn(query: torch.Tensor, ref: torch.Tensor, ref_valid: torch.Tensor,
        k: int = 3):
    """k nearest references for each query point.

    Args: query [Q, 3]; ref [R, 3]; ref_valid [R] bool.
    Returns (dist2 [Q, k] ascending, idx [Q, k] int32); idx -1 and dist inf
    where fewer than k valid references exist."""
    Q, R = query.shape[0], ref.shape[0]
    dist2 = torch.full((Q, k), torch.inf, device=query.device)
    idx = torch.full((Q, k), -1, dtype=torch.int32, device=query.device)
    if Q == 0 or R == 0:
        return dist2, idx
    r_norm = torch.sum(ref * ref, dim=-1)
    rows = max(1, BLOCK_ELEMS // R)
    for s in range(0, Q, rows):
        q = query[s:s + rows]
        q_norm = torch.sum(q * q, dim=-1, keepdim=True)
        d2 = q_norm + r_norm[None, :] - 2.0 * (q @ ref.T)
        d2 = torch.where(ref_valid[None, :], torch.clamp(d2, min=0.0), torch.inf)
        for j in range(min(k, R)):
            best = torch.argmin(d2, dim=1, keepdim=True)   # first minimum
            dist2[s:s + rows, j] = d2.gather(1, best)[:, 0]
            idx[s:s + rows, j] = best[:, 0].to(torch.int32)
            d2.scatter_(1, best, torch.inf)
    idx = torch.where(torch.isinf(dist2), -1, idx)
    return dist2, idx
