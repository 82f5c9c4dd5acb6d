"""The JAX reference of the main path at its own operating point.

``tests/data/slice_opt_680x1200_jax_cpu.json`` is the JAX package's slice
loop (``tests/torch_parity.py::run_jax_sequence``: slam.py's whole-frame
loop, the final pass and the last keyframe's eval) at 680x1200 x 12 frames
with ``bench.make_args`` unchanged, written on the CPU by

    JAX_PLATFORMS=cpu python tests/torch_parity.py --optimize --frames 12 --height 680 --width 1200

(~12 min on 8 cores).  ``chip_smoke.py``'s phase 5r holds the port on the
card to it at ``OPT_REF_TOL``.  These tests run no SLAM: they hold the
fixture to the point phase 5 runs (``bench.make_args(680, 1200)``, map
capacity 2^19, 12 frames, no bin overflow) and phase 5r to the fixture.
"""

import json
import math
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
import bench  # noqa: E402
import chip_smoke  # noqa: E402
import torch_parity  # noqa: E402

H, W, FRAMES = 680, 1200, 12
REF = torch_parity.slice_reference(H, W, True)


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        return json.load(f)


def test_reference_records_its_command(ref):
    assert ref["command"] == ("JAX_PLATFORMS=cpu python tests/torch_parity.py "
                              f"--optimize --frames {FRAMES} --height {H} "
                              f"--width {W}")
    assert ref["config"] == "bench.make_args(H, W, env_overrides=False)"
    assert (ref["frames"], ref["height"], ref["width"]) == (FRAMES, H, W)
    assert ref["jax_version"]
    assert chip_smoke.REF_OPT_680 == REF


def test_reference_is_phase_5s_operating_point():
    """bench.make_args at 680x1200 (what the harness ran) is the port's
    make_args there (what phases 5 and 5r run), at 2^19 slots."""
    from rtgslam_torch.slam.run import make_args

    jargs, _ = bench.make_args(H, W, env_overrides=False)
    pargs = make_args(H, W)
    assert jargs.map_capacity == pargs.map_capacity == 1 << 19
    for k in ("temp_capacity", "block_capacity", "tile_capacity", "max_visible",
              "uniform_sample_num", "gaussian_update_iter",
              "gaussian_update_frame", "final_global_iter", "memory_length",
              "optimize_compact"):
        assert getattr(pargs, k) == getattr(jargs, k), k
    assert jargs.gaussian_update_iter == 50


def test_reference_holds_every_frame(ref):
    assert len(ref["counts"]) == FRAMES
    assert all(len(c) == 2 and c[0] + c[1] > 0 for c in ref["counts"])
    assert len(ref["poses"]) == FRAMES
    # the final pass fixes every gaussian of the last frame's map
    assert (ref["n_stable"], ref["n_unstable"]) == (sum(ref["counts"][-1]), 0)
    assert ref["max_overflow"] == 0
    assert 0 <= ref["eval_uid"] < FRAMES
    for k in ("ate_cm", "psnr", "depth_l1_cm"):
        assert math.isfinite(ref[k]), k
