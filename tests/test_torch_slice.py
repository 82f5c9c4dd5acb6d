"""Port parity: the forward SLAM slice end to end against the JAX
``Tracker`` / ``Mapper`` loop, and the port's independence from JAX.

Configuration: conftest's ``base_args`` with ``gaussian_update_iter = 0``,
``final_global_iter = 0``, ``tile_capacity = 1024`` and ``block_capacity =
4096`` (bin overflow 0), pure-ICP frame-to-model tracking as at the bench
point (``use_gt_pose = False``, ``icp_use_model_depth = True``), 4 frames of
``synthetic_cams`` (96x128).  The port replays the JAX mapper's spawn
priority stream, so both sample the same pixels.

Tolerances, each a few times what was measured on CPU (torch 2.13, jax
0.9): per-frame poses 1e-4 (measured 1.8e-6), ATE 1e-3 cm (measured
8e-5), PSNR 0.01 dB (3e-5), depth L1 0.01 cm (1e-7), gaussian counts per
frame within 1% (measured equal), overflow equal.
"""

import copy
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 4


@pytest.fixture(scope="module")
def slice_runs(base_args, synthetic_cams):
    from rtgslam_torch.slam.run import run_sequence

    args = copy.copy(base_args)
    args.gaussian_update_iter = 0
    args.final_global_iter = 0
    args.tile_capacity = 1024
    args.block_capacity = 4096
    args.use_gt_pose = False
    args.icp_use_model_depth = True
    cams = synthetic_cams[:N_FRAMES]       # shared: tracking rewrites poses
    H, W = cams[0].image.shape[:2]
    ref = tp.run_jax_sequence(args, copy.deepcopy(cams))
    out = run_sequence(args, tp.port_cameras(cams), "cpu",
                       tp.replay(tp.jax_priorities(N_FRAMES, H, W)))
    return out, ref


def test_slice_poses_and_ate(slice_runs):
    out, ref = slice_runs
    np.testing.assert_allclose(out["poses"], ref["poses"], atol=1e-4)
    assert abs(out["ate_cm"] - ref["ate_cm"]) <= 1e-3
    assert out["eval_uid"] == ref["eval_uid"]


def test_slice_eval_quality(slice_runs):
    out, ref = slice_runs
    assert abs(out["eval"]["psnr"] - ref["eval"]["psnr"]) <= 0.01
    assert abs(out["eval"]["depth_l1_cm"] - ref["eval"]["depth_l1_cm"]) <= 0.01
    assert np.isfinite(out["eval"]["ssim"]) and np.isfinite(out["eval"]["ms_ssim"])


def test_slice_gaussian_counts_and_overflow(slice_runs):
    out, ref = slice_runs
    for (u, s), (ru, rs) in zip(out["counts"], ref["counts"]):
        assert abs((u + s) - (ru + rs)) <= 0.01 * (ru + rs)
        assert abs(s - rs) <= 0.01 * max(rs, 1)
    assert out["n_stable"] > 0 and out["n_unstable"] == ref["n_unstable"] == 0
    assert abs(out["n_stable"] - ref["n_stable"]) <= 0.01 * ref["n_stable"]
    assert out["max_overflow"] == ref["max_overflow"] == 0


def test_port_runs_without_jax():
    """The port's slice on CPU in a fresh interpreter never loads JAX or
    the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        from rtgslam_torch.data.synthetic import make_cameras
        from rtgslam_torch.slam.run import make_args, run_sequence
        args = make_args(48, 64)
        res = run_sequence(args, make_cameras(2, 48, 64), "cpu")
        assert res["n_stable"] > 0 and res["max_overflow"] == 0, res
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "rtgslam_tpu", "flax")]
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
