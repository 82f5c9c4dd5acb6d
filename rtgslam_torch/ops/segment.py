"""Per-gaussian error accumulation and stable partitions.

Port of ``rtgslam_tpu/ops/segment.py`` (the reference's CUDA
``accumulate_gaussian_error``, call site ``SLAM/multiprocess/mapper.py:541-559``).
"""

from __future__ import annotations

import torch

from ..utils import perf


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 in [0, 2^32) with the floats' order."""
    b = x.view(torch.int32).long()
    return torch.where(b < 0, ~b, b | (1 << 31)) & 0xFFFFFFFF


def segment_sum(values: torch.Tensor, seg: torch.Tensor, n: int):
    """Per-segment sums and counts of float32 ``values`` over ``seg`` ids in
    [0, n), in an order fixed by the data alone: the pairs sorted by (id,
    value), then each segment summed over its sorted run.  Reordering the
    pairs leaves every sum bitwise unchanged, and no atomics take part, so
    a rerun on the card repeats bit for bit."""
    order = torch.sort(seg * (1 << 32) + _ordered_bits(values)).indices
    seg_sorted = seg[order]
    ptr = torch.searchsorted(seg_sorted,
                             torch.arange(n + 1, device=seg.device))
    lengths = ptr[1:] - ptr[:-1]
    # on the card the reduce reads the lengths back to the host
    with perf.span("map.segment_fetch"):
        total = torch.segment_reduce(values[order], "sum", lengths=lengths)
    return total, lengths


def accumulate_gaussian_error(color_error, depth_error, normal_error,
                              color_index, depth_index, num_gaussians: int):
    """Mean per-gaussian color / depth / normal errors (``:22``).

    Color errors scatter along ``color_index``; depth and normal errors along
    ``depth_index`` (-1 = no gaussian).  Returns three [P] tensors, zero
    where a gaussian was never hit.  The sums run in a fixed order
    (:func:`segment_sum`), on the CPU as on the card."""

    def segment_mean(err, idx):
        err = err.reshape(-1).to(torch.float32)
        idx = idx.reshape(-1).long()
        valid = idx >= 0
        seg = torch.where(valid, idx, num_gaussians)   # spill row for invalid
        total, count = segment_sum(torch.where(valid, err, 0.0), seg,
                                   num_gaussians + 1)
        return total[:num_gaussians] / torch.clamp(
            count[:num_gaussians].to(torch.float32), min=1.0)

    return (segment_mean(color_error, color_index),
            segment_mean(depth_error, depth_index),
            segment_mean(normal_error, depth_index))


def stable_partition_order(mask: torch.Tensor) -> torch.Tensor:
    """Permutation putting ``mask``-true rows first, original order kept
    within each side (``:57``)."""
    return torch.sort((~mask).to(torch.uint8), stable=True).indices.to(torch.int32)
