"""rtgslam_torch — the PyTorch + CUDA (NVIDIA Hopper) port of rtgslam_tpu.

Mirrors the layout and names of ``rtgslam_tpu`` so each module's
counterpart is easy to find.  The JAX package is the reference; this
package imports torch and numpy and nothing of JAX or of ``rtgslam_tpu``.

This slice ports the forward SLAM path (tracking, map growth, rendering)
with no gradient map optimization.  Its one hand-written kernel is K1, the
forward tile blend (``csrc/blend_fwd.cu``, built at first use).
"""

import torch

__version__ = "0.1.0"


def setup_device(device) -> torch.device:
    """Resolve ``device`` and switch TF32 off, so float32 matrix products
    and convolutions run in full float32 (the ICP normal equations and the
    SSIM filter need it; the JAX package asks for HIGHEST precision for the
    same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(device)
