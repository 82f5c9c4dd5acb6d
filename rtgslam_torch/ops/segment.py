"""Per-gaussian error accumulation and stable partitions.

Port of ``rtgslam_tpu/ops/segment.py`` (the reference's CUDA
``accumulate_gaussian_error``, call site ``SLAM/multiprocess/mapper.py:541-559``).
"""

from __future__ import annotations

import torch


def accumulate_gaussian_error(color_error, depth_error, normal_error,
                              color_index, depth_index, num_gaussians: int):
    """Mean per-gaussian color / depth / normal errors (``:22``).

    Color errors scatter along ``color_index``; depth and normal errors along
    ``depth_index`` (-1 = no gaussian).  Returns three [P] tensors, zero
    where a gaussian was never hit."""

    def segment_mean(err, idx):
        err = err.reshape(-1).to(torch.float32)
        idx = idx.reshape(-1).long()
        valid = idx >= 0
        seg = torch.where(valid, idx, num_gaussians)   # spill row for invalid
        total = err.new_zeros(num_gaussians + 1).index_add_(
            0, seg, torch.where(valid, err, 0.0))
        count = err.new_zeros(num_gaussians + 1).index_add_(
            0, seg, valid.to(torch.float32))
        return total[:num_gaussians] / torch.clamp(count[:num_gaussians], min=1.0)

    return (segment_mean(color_error, color_index),
            segment_mean(depth_error, depth_index),
            segment_mean(normal_error, depth_index))


def stable_partition_order(mask: torch.Tensor) -> torch.Tensor:
    """Permutation putting ``mask``-true rows first, original order kept
    within each side (``:57``)."""
    return torch.sort((~mask).to(torch.uint8), stable=True).indices.to(torch.int32)
