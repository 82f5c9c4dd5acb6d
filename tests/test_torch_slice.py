"""Port parity: the SLAM loop end to end against the JAX ``Tracker`` /
``Mapper`` loop, forward-only and with gradient optimization, and the
port's independence from JAX.

Configuration: conftest's ``base_args`` with ``tile_capacity = 1024`` and
``block_capacity = 4096`` (bin overflow 0), pure-ICP frame-to-model tracking
as at the bench point (``use_gt_pose = False``, ``icp_use_model_depth =
True``), 4 frames of ``synthetic_cams`` (96x128).  The port replays the JAX
mapper's spawn priority stream, so both sample the same pixels, and draws
the optimize passes' frame sequences from the same numpy stream.

Forward-only (``gaussian_update_iter = final_global_iter = 0``), each
tolerance a few times what was measured on CPU (torch 2.13, jax 0.9):
per-frame poses 1e-4 (measured 1.8e-6), ATE 1e-3 cm (measured 8e-5), PSNR
0.01 dB (3e-5), depth L1 0.01 cm (1e-7), gaussian counts per frame within
1% (measured equal), overflow equal.

With optimization (10 iterations on frames 0, 1 and 3 over a 3-frame
memory, ``final_global_iter = 2``): Adam with eps 1e-15 turns rounding
differences into lr-sized steps, so after 30 iterations the two maps differ
elementwise and the comparison is end to end.  Measured on CPU: poses
1.3e-4, ATE 2.9e-3 cm, PSNR 7e-3 dB, depth L1 2.1e-3 cm, counts equal;
held to poses 1e-3, ATE 0.01 cm, PSNR 0.05 dB, depth L1 0.01 cm, gaussian
counts per frame within 1%, overflow equal.
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


def _run_both(base_args, synthetic_cams, gaussian_update_iter,
              final_global_iter):
    from rtgslam_torch.slam.run import run_sequence

    args = copy.copy(base_args)
    args.gaussian_update_iter = gaussian_update_iter
    args.final_global_iter = final_global_iter
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


@pytest.fixture(scope="module")
def slice_runs(base_args, synthetic_cams):
    return _run_both(base_args, synthetic_cams, 0, 0)


@pytest.fixture(scope="module")
def opt_runs(base_args, synthetic_cams):
    assert base_args.gaussian_update_iter == 10
    assert base_args.gaussian_update_frame == 2
    return _run_both(base_args, synthetic_cams, 10, 2)


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


def test_opt_slice_poses_and_ate(opt_runs):
    out, ref = opt_runs
    assert out["optimize_frames"] == [0, 1, 3]
    np.testing.assert_allclose(out["poses"], ref["poses"], atol=1e-3)
    assert abs(out["ate_cm"] - ref["ate_cm"]) <= 0.01
    assert out["eval_uid"] == ref["eval_uid"]


def test_opt_slice_eval_quality(opt_runs):
    out, ref = opt_runs
    assert abs(out["eval"]["psnr"] - ref["eval"]["psnr"]) <= 0.05
    assert abs(out["eval"]["depth_l1_cm"] - ref["eval"]["depth_l1_cm"]) <= 0.01
    assert np.isfinite(out["eval"]["ssim"]) and np.isfinite(out["eval"]["ms_ssim"])


def test_opt_slice_gaussian_counts_and_overflow(opt_runs):
    out, ref = opt_runs
    for (u, s), (ru, rs) in zip(out["counts"], ref["counts"]):
        assert abs((u + s) - (ru + rs)) <= 0.01 * (ru + rs)
        assert abs(s - rs) <= 0.01 * max(rs, 1)
    assert out["n_stable"] > 0 and out["n_unstable"] == ref["n_unstable"] == 0
    assert abs(out["n_stable"] - ref["n_stable"]) <= 0.01 * ref["n_stable"]
    assert out["max_overflow"] == ref["max_overflow"] == 0


def test_port_runs_without_jax(tmp_path):
    """In a fresh interpreter where importing JAX or the JAX package fails,
    the port's modules and its three entry points import, the slice runs on
    the CPU, and ``slam_torch.py`` / ``metric_torch.py`` / ``slam_mp_torch.py``
    run a 3-frame scene written to disk."""
    code = textwrap.dedent("""
        import importlib, sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "rtgslam_tpu", "flax"):
                    raise ImportError("blocked: " + name)
        sys.meta_path.insert(0, Block())
        import torch
        torch.set_num_threads(1)
        for m in ("slam_torch", "metric_torch", "slam_mp_torch",
                  "rtgslam_torch.config",
                  "rtgslam_torch.data.camera", "rtgslam_torch.data.dataset",
                  "rtgslam_torch.data.loader", "rtgslam_torch.data.synthetic",
                  "rtgslam_torch.models.densify", "rtgslam_torch.models.gaussian_map",
                  "rtgslam_torch.models.lpips", "rtgslam_torch.ops.knn",
                  "rtgslam_torch.slam.eval", "rtgslam_torch.slam.mapper",
                  "rtgslam_torch.slam.tracker", "rtgslam_torch.slam.pose_backend",
                  "rtgslam_torch.slam.native_backend",
                  "rtgslam_torch.slam.loop_closure", "rtgslam_torch.slam.system",
                  "rtgslam_torch.utils.general",
                  "rtgslam_torch.utils.image_io", "rtgslam_torch.utils.monitor",
                  "rtgslam_torch.utils.ply", "rtgslam_torch.utils.traj"):
            importlib.import_module(m)
        from rtgslam_torch.data.synthetic import make_cameras, write_scene
        from rtgslam_torch.slam.run import make_args, run_sequence
        args = make_args(48, 64)
        res = run_sequence(args, make_cameras(2, 48, 64), "cpu")
        assert res["n_stable"] > 0 and res["max_overflow"] == 0, res
        tmp = sys.argv[1]
        scene = write_scene(tmp + "/scene", 3, 48, 64)
        with open(tmp + "/c.yaml", "w") as f:
            f.write("parent: configs/synthetic/room.yaml\\n"
                    f"source_path: {scene}\\nsave_path: {tmp}/out\\n"
                    "map_capacity: 8192\\ntemp_capacity: 2048\\n"
                    "uniform_sample_num: 800\\ngaussian_update_iter: 3\\n"
                    "gaussian_update_frame: 2\\nfinal_global_iter: 2\\n"
                    "save_step: 2\\n")
        import metric_torch, slam_torch
        out = slam_torch.main(["--config", tmp + "/c.yaml", "--device", "cpu"])
        assert out["final_eval"]["psnr"] > 15, out["final_eval"]
        met = metric_torch.main(["--config", tmp + "/c.yaml", "--device", "cpu"])
        assert len(met["rows"]) == 3 and met["mean"]["psnr"] > 15, met["mean"]
        import slam_mp_torch
        with open(tmp + "/mp.yaml", "w") as f:
            f.write(f"parent: {tmp}/c.yaml\\nsave_path: {tmp}/out_mp\\n"
                    "sync_tracker2mapper_frames: 1\\ntracker_max_fps: 1000\\n")
        mp = slam_mp_torch.main(["--config", tmp + "/mp.yaml", "--device", "cpu"])
        assert mp["ate_cm"] < 1.0 and mp["mapper"].get_stable_num > 0, mp
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "rtgslam_tpu", "flax")]
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
