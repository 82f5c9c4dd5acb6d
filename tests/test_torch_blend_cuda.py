"""Kernel K1 (rtgslam_torch/csrc/blend_fwd.cu) against its plain PyTorch
twin on the card.  CUDA kernels have no CPU mode, so these tests skip
without a CUDA device; ``python3 chip_smoke.py`` runs the same comparison
at the main path's shapes.

    python -m pytest tests/test_torch_blend_cuda.py --noconftest -o addopts=""

(``--noconftest``: the tests' conftest sets JAX up, and these need no JAX.)

Tolerance: 1e-5 absolute on color, T, depth and weights (the kernel takes
transmittance as a sequential product, the twin in log space; rounding
only); index maps equal except at verified near-ties.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 runs only on the card")
    from rtgslam_torch import setup_device

    return setup_device("cuda:0")


@pytest.mark.parametrize("Kt,seed", [(128, 0), (512, 1), (64, 2)])
def test_k1_matches_plain_twin(device, Kt, seed):
    import chip_smoke
    from rtgslam_torch.ops.rasterize import blend

    feat, order, lists, counts, origins = chip_smoke.random_tiles(
        device, T=96, Kt=Kt, V=4000, seed=seed)
    before = blend.blend_tiles.launches
    out = blend.blend_tiles(feat, order, lists, counts, origins, 0.6, 1e-4)
    assert blend.blend_tiles.launches == before + 1
    ref = blend.blend_tiles_reference(feat, order, lists, counts, origins, 0.6, 1e-4)
    torch.cuda.synchronize()
    err, _, _ = chip_smoke.compare_blend(out, ref, feat, order, origins, 0.6)
    assert err <= 1e-5


def test_k1_rejects_bad_inputs(device):
    import chip_smoke
    from rtgslam_torch.ops.rasterize import blend

    feat, order, lists, counts, origins = chip_smoke.random_tiles(
        device, T=8, Kt=128, V=400)
    with pytest.raises(TypeError):
        blend.blend_tiles(feat, order.long(), lists, counts, origins, 0.6)
    with pytest.raises(ValueError):
        blend.blend_tiles(feat, order, lists.cpu(), counts, origins, 0.6)
