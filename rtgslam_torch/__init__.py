"""rtgslam_torch — the PyTorch + CUDA (NVIDIA Hopper) port of rtgslam_tpu.

Mirrors the layout and names of ``rtgslam_tpu`` so each module's
counterpart is easy to find.  The JAX package is the reference; this
package imports torch and numpy and nothing of JAX or of ``rtgslam_tpu``.

It holds the SLAM loop (tracking, with the native pose backend and loop
closure on the staged path; map growth, rendering, the gradient map
optimization), the pipelined tracker / mapper system, the dataset
readers, PLY checkpoints and the eval, driven by ``slam_torch.py``,
``slam_mp_torch.py`` and ``metric_torch.py`` at the repository root.  Its
hand-written kernels are K1, the forward tile blend
(``csrc/blend_fwd.cu``), and K2, the backward tile blend
(``csrc/blend_bwd.cu``), both built at first use, as is the host-side pose
backend (``csrc/pose_backend.cc``, g++).
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
