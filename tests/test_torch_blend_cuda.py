"""Kernels K1 (rtgslam_torch/csrc/blend_fwd.cu, inference, residual and
transmission modes) and K2 (csrc/blend_bwd.cu) against their plain PyTorch
twins on the card.  CUDA kernels have no CPU mode, so these tests skip
without a CUDA device; ``python3 chip_smoke.py`` runs the same comparisons
at the main path's shapes.

    python -m pytest tests/test_torch_blend_cuda.py --noconftest -o addopts=""

(``--noconftest``: the tests' conftest sets JAX up, and these need no JAX.)

Tolerances: 1e-5 absolute on color, T, entry T, depth and weights (the
kernel takes transmittance as a sequential product, the twin in log space;
rounding only); index maps equal except at verified near-ties, ``done``
except at verified exit-threshold ties, the mask T != 1 exactly; K2 column
by column within 1e-4 of the column's largest gradient plus 1e-6 of the
largest of any column, its elig column exactly 0 (another summation order,
atomics across tiles; ``chip_smoke.compare_bwd``).
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
    before = blend.launches["blend_fwd"]
    out = blend.blend_tiles(feat, order, lists, counts, origins, 0.6, 1e-4)
    assert blend.launches["blend_fwd"] == before + 1
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


@pytest.mark.parametrize("Kt,seed", [(128, 3), (512, 4), (64, 5)])
def test_k1_modes_match_plain_twins(device, Kt, seed):
    import chip_smoke
    from rtgslam_torch.ops.rasterize import blend

    feat, order, lists, counts, origins = chip_smoke.random_tiles(
        device, T=96, Kt=Kt, V=4000, seed=seed)
    args = (feat, order, lists, counts, origins, 0.6, 1e-4)
    before = dict(blend.launches)
    out, entry, done = blend.blend_tiles(*args, residuals=True)
    cols6 = feat[:, [0, 1, 2, 3, 4, 9]].contiguous()
    T = blend.blend_transmission(cols6, lists, counts, origins, 1e-4)
    assert blend.launches["blend_fwd_residual"] == before["blend_fwd_residual"] + 1
    assert (blend.launches["blend_fwd_transmission"]
            == before["blend_fwd_transmission"] + 1)
    ref, ref_entry, ref_done = blend.blend_tiles_reference(*args, residuals=True)
    torch.cuda.synchronize()
    chip_smoke.compare_blend(out, ref, feat, order, origins, 0.6)
    chip_smoke.compare_residuals(entry, done, ref_entry, ref_done, 1e-4)
    chip_smoke.compare_transmission(
        T, blend.blend_transmission_reference(cols6, lists, counts, origins,
                                              1e-4))


@pytest.mark.parametrize("Kt,seed", [(128, 6), (512, 7)])
def test_k2_matches_plain_backward(device, Kt, seed):
    import chip_smoke
    from rtgslam_torch.ops.rasterize import blend

    feat, order, lists, counts, origins = chip_smoke.random_tiles(
        device, T=96, Kt=Kt, V=4000, seed=seed)
    ref, entry, done = blend.blend_tiles_reference(
        feat, order, lists, counts, origins, 0.6, 1e-4, residuals=True)
    gc, gd, gt = chip_smoke.random_cotangents(lists.shape[0], device, seed)
    bargs = (feat, order, lists, origins, entry, done, gc, gd,
             ref.T_final * gt, ref.depth_index, 0.6)
    before = blend.launches["blend_bwd"]
    g = blend.blend_bwd(*bargs)
    assert blend.launches["blend_bwd"] == before + 1
    torch.cuda.synchronize()
    chip_smoke.compare_bwd(g, blend.blend_bwd_reference(*bargs), "K2 test")
    assert float(g[-1].abs().max()) == 0.0   # the sentinel row


def test_blend_function_gradient_on_card(device):
    """BlendFunction on CUDA (K1 residual forward, K2 backward) against the
    same function on the CPU (the plain twins)."""
    import chip_smoke
    from rtgslam_torch.ops.rasterize import blend

    inputs = chip_smoke.random_tiles(device, T=48, Kt=256, V=3000, seed=9)
    gc, gd, gt = chip_smoke.random_cotangents(48, device, 9)
    grads = []
    for dev in (device, torch.device("cpu")):
        feat, *rest = (x.to(dev) for x in inputs)
        feat = feat.clone().requires_grad_(True)
        out = blend.blend_tiles_fused(feat, *rest, 0.6, 1e-4)
        loss = ((out.color * gc.to(dev)).sum() + (out.depth * gd.to(dev)).sum()
                + (out.T_final * gt.to(dev)).sum())
        grads.append(torch.autograd.grad(loss, feat)[0].cpu())
    chip_smoke.compare_bwd(grads[0], grads[1], "BlendFunction")
