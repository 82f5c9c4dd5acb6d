"""Kernels K1 (rtgslam_torch/csrc/blend_fwd.cu, inference, residual and
transmission modes), K2 and its reduce (csrc/blend_bwd.cu) against their
plain PyTorch twins on the card.  CUDA kernels have no CPU mode, so these
tests skip without a CUDA device; ``python3 chip_smoke.py`` runs the same
comparisons at the main path's shapes.

    python -m pytest tests/test_torch_blend_cuda.py --noconftest -o addopts=""

(``--noconftest``: the tests' conftest sets JAX up, and these need no JAX.)

The random tiles include counts at the walks' trim edges (0, 1, chunk - 1,
chunk, chunk + 1 and Kt; ``chip_smoke.random_tiles``).

Tolerances: 1e-5 absolute on color, T, entry T, chunk colours, depth and
weights (the kernel takes transmittance as a sequential product, the twin
in log space; rounding only); index maps equal except at verified
near-ties, ``done`` except at verified exit-threshold ties, the mask
T != 1 exactly; K2 column by column within 1e-4 of the column's largest
gradient plus 1e-6 of the largest of any column, its elig column exactly 0
(``chip_smoke.compare_bwd``): the kernel sums each entry's per-pixel terms
in a fixed order of its own (a warp butterfly, then the warps, then the
tiles in list order), the twin in PyTorch's, on transmittances that differ
by rounding.  The reduce is held to its twin bitwise (both add each row's
positions in the same order), and K2 with the reduce to itself bitwise
across launches.
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
    out, entry, done, chunk_color = blend.blend_tiles(*args, residuals=True)
    cols6 = feat[:, [0, 1, 2, 3, 4, 9]].contiguous()
    T = blend.blend_transmission(cols6, lists, counts, origins, 1e-4)
    assert blend.launches["blend_fwd_residual"] == before["blend_fwd_residual"] + 1
    assert (blend.launches["blend_fwd_transmission"]
            == before["blend_fwd_transmission"] + 1)
    ref, *ref_res = blend.blend_tiles_reference(*args, residuals=True)
    torch.cuda.synchronize()
    chip_smoke.compare_blend(out, ref, feat, order, origins, 0.6)
    chip_smoke.compare_residuals((entry, done, chunk_color), ref_res, 1e-4)
    chip_smoke.compare_transmission(
        T, blend.blend_transmission_reference(cols6, lists, counts, origins,
                                              1e-4))


def _k2_args(device, Kt, seed, T=96):
    import chip_smoke
    from rtgslam_torch.ops.rasterize import blend

    feat, order, lists, counts, origins = chip_smoke.random_tiles(
        device, T=T, Kt=Kt, V=4000, seed=seed)
    ref, entry, done, chunk_color = blend.blend_tiles_reference(
        feat, order, lists, counts, origins, 0.6, 1e-4, residuals=True)
    gc, gd, gt = chip_smoke.random_cotangents(lists.shape[0], device, seed)
    return (feat, order, lists, counts, origins, entry, done, chunk_color, gc,
            gd, ref.T_final * gt, ref.depth_index, 0.6)


@pytest.mark.parametrize("Kt,seed", [(128, 6), (512, 7), (85, 8)])
def test_k2_matches_plain_backward(device, Kt, seed):
    import chip_smoke
    from rtgslam_torch.ops.rasterize import blend

    bargs = _k2_args(device, Kt, seed)
    before = dict(blend.launches)
    g = blend.blend_bwd(*bargs)
    assert blend.launches["blend_bwd"] == before["blend_bwd"] + 1
    assert blend.launches["blend_bwd_reduce"] == before["blend_bwd_reduce"] + 1
    torch.cuda.synchronize()
    chip_smoke.compare_bwd(g, blend.blend_bwd_reference(*bargs), "K2 test")
    assert float(g[-1].abs().max()) == 0.0   # the sentinel row


@pytest.mark.parametrize("Kt,seed", [(128, 10), (512, 11)])
def test_k2_is_bitwise_repeatable_and_reduce_matches_twin(device, Kt, seed):
    """Two launches of K2 and the reduce on the same inputs give equal
    gradients, bit for bit; the reduce equals its twin on K2's partials."""
    from rtgslam_torch.ops.rasterize import blend

    bargs = _k2_args(device, Kt, seed)
    index = blend.row_index(bargs[2], bargs[3], bargs[0].shape[0] - 1)
    g1 = blend.blend_bwd(*bargs, index)
    g2 = blend.blend_bwd(*bargs)          # the index built in the wrapper
    partials = blend.blend_bwd_partials(*bargs)
    red = blend.blend_bwd_reduce(partials, index, bargs[6])
    torch.cuda.synchronize()
    assert torch.equal(g1, g2) and torch.equal(g1, red)
    assert torch.equal(red, blend.blend_bwd_reduce_reference(
        partials, index, bargs[6]))


def test_k2_rejects_bad_inputs(device):
    from rtgslam_torch.ops.rasterize import blend

    bargs = list(_k2_args(device, 128, 12, T=8))
    with pytest.raises(ValueError):
        blend.blend_bwd(*bargs[:3], bargs[3].cpu(), *bargs[4:])
    with pytest.raises(TypeError):
        blend.blend_bwd(*bargs[:7], bargs[7].double(), *bargs[8:])


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
