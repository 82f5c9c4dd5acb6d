"""Per-frame render quality (port of ``rtgslam_tpu/slam/eval.py``,
``eval_picture`` :39 and ``eval_frame`` :94; reference ``SLAM/eval.py``).
LPIPS is not computed: the JAX package reports it only when AlexNet
weights are supplied, and the repository ships none."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models import losses


def eval_picture(render_out: Dict, gt_color: torch.Tensor,
                 gt_depth: torch.Tensor) -> Dict[str, float]:
    """PSNR, SSIM, MS-SSIM, depth L1 (cm), valid-pixel ratio and the
    render's bin overflow."""
    img = render_out["render"].clamp(0, 1)
    depth = render_out["depth"][..., 0]
    gt_d = gt_depth[..., 0] if gt_depth.ndim == 3 else gt_depth
    valid = (gt_d > 0) & (depth > 0)
    n_valid = int(valid.sum())
    depth_l1 = (float(torch.abs(depth - gt_d)[valid].mean() * 100)
                if n_valid else 0.0)
    return {
        "psnr": float(losses.psnr(img, gt_color)),
        "ssim": float(losses.ssim(img, gt_color)),
        "ms_ssim": float(losses.ms_ssim(img, gt_color)),
        "depth_l1_cm": depth_l1,
        "valid_ratio": n_valid / max(int((gt_d > 0).sum()), 1),
        "bin_overflow": int(render_out.get("overflow", 0)),
    }


def eval_frame(mapper, frame) -> Dict[str, float]:
    """Render ``frame`` from the current map (all alive gaussians) and
    score it against the frame's RGBD."""
    dev = mapper.device
    out = mapper._render(frame.device_dict(dev))
    return eval_picture(
        out, torch.as_tensor(np.asarray(frame.image, np.float32), device=dev),
        torch.as_tensor(np.asarray(frame.depth, np.float32), device=dev))
