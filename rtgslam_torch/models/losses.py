"""Optimization losses and image metrics.

Port of ``l1_loss`` (:16), ``l2_loss`` (:20), ``masked_mean`` (:24),
``psnr`` (:32), ``ssim`` (:45), ``ms_ssim`` (:72) and ``cosine_distance``
(:91) from ``rtgslam_tpu/models/losses.py``
(reference ``utils/loss_utils.py``: 11x11
gaussian window, sigma 1.5, the standard stability constants).  The SSIM
filter is a float32 depthwise convolution; ``setup_device`` keeps cuDNN
off TF32 for it, as the JAX code asks for HIGHEST precision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over masked entries; 0 when the mask is empty."""
    mask = mask.to(values.dtype)
    denom = torch.sum(mask)
    return torch.where(denom > 0,
                       torch.sum(values * mask) / torch.clamp(denom, min=1.0),
                       0.0)


def psnr(img: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img - gt) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(img: torch.Tensor, gt: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """SSIM over [H, W, C] images in [0, 1]; NaN for an empty image, as the
    JAX package's mean over no pixels (MS-SSIM's coarsest scales of a row
    band under 16 rows)."""
    if img.numel() == 0:
        return torch.tensor(float("nan"), device=img.device)
    C = img.shape[-1]
    kernel = _gaussian_window(window_size, 1.5, img.device)[None, None].repeat(C, 1, 1, 1)

    def filt(x):
        y = F.conv2d(x.permute(2, 0, 1)[None], kernel, padding=window_size // 2,
                     groups=C)
        return y[0].permute(1, 2, 0)

    mu1, mu2 = filt(img), filt(gt)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1 = filt(img * img) - mu1_sq
    sigma2 = filt(gt * gt) - mu2_sq
    sigma12 = filt(img * gt) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    s = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1 + sigma2 + C2))
    return torch.mean(s)


def ms_ssim(img: torch.Tensor, gt: torch.Tensor, levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM with the power weights of Wang et al."""
    weights = torch.tensor([0.0448, 0.2856, 0.3001, 0.2363, 0.1333],
                           device=img.device)[:levels]

    def down(x):
        H, W, C = x.shape
        H2, W2 = H // 2 * 2, W // 2 * 2
        return x[:H2, :W2].reshape(H2 // 2, 2, W2 // 2, 2, C).mean(dim=(1, 3))

    vals = []
    a, b = img, gt
    for _ in range(levels):
        vals.append(torch.clamp(ssim(a, b), 0.0, 1.0))
        a, b = down(a), down(b)
    return torch.prod(torch.stack(vals) ** weights)


def cosine_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - cos similarity along the last axis."""
    num = torch.sum(a * b, dim=-1)
    den = torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1) + 1e-8
    return 1.0 - num / den
