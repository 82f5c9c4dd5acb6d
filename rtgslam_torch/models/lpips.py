"""LPIPS (AlexNet variant) on tensors.

Port of ``rtgslam_tpu/models/lpips.py``.  The reference scores LPIPS-alex
per frame (``SLAM/eval.py:38-147``).  The metric needs pretrained AlexNet
features and per-layer linear heads, which the repository does not ship and
nothing may download, so it is gated: ``LPIPS_WEIGHTS`` names an ``.npz``
in the layout of ``scripts/export_lpips_weights.py`` and :func:`lpips`
computes the value, else it returns ``None`` and the eval leaves the column
out (never NaN).

npz keys:
  conv0_w conv0_b ... conv4_w conv4_b   AlexNet feature convs (OIHW)
  lin0 ... lin4                         1x1 linear head weights [C]

The five convolutions and two max pools run as ``F.conv2d`` /
``F.max_pool2d`` (library calls; the JAX package has no Pallas kernel here).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet feature extractor: (out_ch, kernel, stride, pad)
_CONVS = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
          (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}          # maxpool(3, stride 2) after these convs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@functools.lru_cache(maxsize=2)
def _read_npz(path: str, mtime_ns: int) -> Dict[str, np.ndarray]:
    with np.load(path) as npz:
        return {k: npz[k] for k in npz.files}


def load_weights(path: Optional[str] = None) -> Optional[Dict[str, np.ndarray]]:
    """The npz at ``path`` (default ``LPIPS_WEIGHTS``) as read-only arrays
    (read once per file version), or None when neither names an existing
    file."""
    path = path or os.environ.get("LPIPS_WEIGHTS", "")
    if not path or not os.path.exists(path):
        return None
    return _read_npz(os.path.abspath(path), os.stat(path).st_mtime_ns)


def _features(x: torch.Tensor, w: Dict[str, torch.Tensor]):
    """x: [N, 3, H, W] in [-1, 1] -> the 5 channel-normalized feature maps."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    x = (x - shift[None, :, None, None]) / scale[None, :, None, None]
    feats = []
    for i, (_, _, s, p) in enumerate(_CONVS):
        x = F.relu(F.conv2d(x, w[f"conv{i}_w"], w[f"conv{i}_b"], stride=s,
                            padding=p))
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + 1e-10)
        feats.append(x / norm)
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return feats


def lpips(img: torch.Tensor, gt: torch.Tensor,
          weights_path: Optional[str] = None) -> Optional[float]:
    """LPIPS between [H, W, 3] images in [0, 1] (tensors on one device);
    None without weights (``lpips`` :78)."""
    weights = load_weights(weights_path)
    if weights is None:
        return None
    dev = img.device
    w = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
         for k, v in weights.items()}
    a = img.to(torch.float32).permute(2, 0, 1)[None] * 2.0 - 1.0
    b = gt.to(torch.float32).permute(2, 0, 1)[None] * 2.0 - 1.0
    total = torch.zeros((), device=dev)
    for i, (xa, xb) in enumerate(zip(_features(a, w), _features(b, w))):
        lin = w[f"lin{i}"].reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum((xa - xb) ** 2 * lin, dim=1))
    return float(total)
