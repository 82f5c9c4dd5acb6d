"""The bilateral depth filter's kernel (``rtgslam_torch/csrc/bilateral.cu``)
against its plain loop (``ops/preprocess.py::bilateral_filter_plain``) on
the card, bitwise.  CUDA kernels have no CPU mode, so these tests skip
without a CUDA device.

    python -m pytest tests/test_torch_bilateral_cuda.py --noconftest -o addopts=""

(``--noconftest``: the tests' conftest sets JAX up, and these need no JAX.)

The frames: one at 480x640 and one at 680x1200 ray-cast by
``benchmark/scene.py`` with TUM's Kinect noise and quantisation, zero-depth
holes punched in (scattered pixels and a block); random depth at 37x53,
5x5 (smaller than the disc) and 1x1; an all-zero frame and one with a
single valid pixel.  Each as ``[H, W]`` and ``[H, W, 1]``, at the tracker's
radius 5 and sigmas 2, 2, and at radius 3 with sigmas 1.5 (colour, whose
reciprocal 1 / 4.5 is inexact) and 0.7 (space).  Also: no host sync inside
the launch, and a side stream gives the default stream's bits.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

pytestmark = pytest.mark.cuda
CASES = ["tum_480x640", "replica_680x1200", "37x53", "5x5", "1x1", "zeros",
         "one_valid"]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bilateral kernel runs only on the card")
    from rtgslam_torch import setup_device

    return setup_device("cuda:0")


@pytest.fixture(scope="module")
def frames(device):
    """[H, W] float32 depth frames on the card, by case name."""
    import torch_parity as tp

    gen = torch.Generator(device=device).manual_seed(20)
    out = {"tum_480x640": tp.kinect_depth("fr1_desk", 480, 640, device, gen),
           "replica_680x1200": tp.kinect_depth("orbit", 680, 1200, device, gen)}
    for case, (H, W) in (("37x53", (37, 53)), ("5x5", (5, 5)), ("1x1", (1, 1))):
        depth = 0.5 + 3.0 * torch.rand((H, W), generator=gen, device=device)
        out[case] = tp.depth_holes(depth, gen) if H > 1 else depth
    out["zeros"] = torch.zeros((24, 40), device=device)
    one = torch.zeros((24, 40), device=device)
    one[11, 17] = 1.25
    out["one_valid"] = one
    return out


def _same(frames, case, channel, *params):
    from rtgslam_torch.ops import preprocess

    depth = frames[case][..., None] if channel else frames[case]
    before = preprocess.launches["bilateral"]
    got = preprocess.bilateral_filter(depth, *params)
    assert preprocess.launches["bilateral"] == before + 1
    want = preprocess.bilateral_filter_plain(depth, *params)
    torch.cuda.synchronize()
    assert got.shape == want.shape == depth.shape
    differ = int((got != want).sum())
    assert torch.equal(got, want), (
        f"{case}: {differ} pixels differ, largest "
        f"{float((got - want).abs().max()):.3g}")
    return got


@pytest.mark.parametrize("channel", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_the_plain_loop(frames, case, channel):
    got = _same(frames, case, channel, 5, 2.0, 2.0)
    if case == "zeros":
        assert not got.any()
    if case == "one_valid":   # the valid pixel spreads over its disc only
        assert int((got != 0).sum()) == 81


@pytest.mark.parametrize("case", ["tum_480x640", "37x53", "5x5"])
def test_another_radius_and_sigmas(frames, case):
    _same(frames, case, False, 3, 1.5, 0.7)


def test_no_host_sync_inside_the_launch(frames):
    from rtgslam_torch.ops import preprocess

    depth = frames["tum_480x640"]
    preprocess.bilateral_filter(depth)   # the build and the binding first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = preprocess.bilateral_filter(depth)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(out, preprocess.bilateral_filter_plain(depth))


def test_a_side_stream_gives_the_same_bits(frames):
    from rtgslam_torch.ops import preprocess

    depth = frames["replica_680x1200"]
    want = preprocess.bilateral_filter(depth)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = preprocess.bilateral_filter(depth)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_refuses_what_the_kernel_does_not_take(frames):
    from rtgslam_torch.ops import preprocess

    depth = frames["37x53"]
    for bad, params, err in ((depth.double(), (), TypeError),
                             (depth.t(), (), TypeError),
                             (depth[..., None].expand(37, 53, 2).contiguous(), (),
                              ValueError),
                             (depth, (preprocess.MAX_RADIUS + 1,), ValueError)):
        with pytest.raises(err):
            preprocess.bilateral_filter(bad, *params)
