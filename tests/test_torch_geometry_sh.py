"""Port parity: geometry, SH, the camera / synthetic-scene / ATE copies and
the config — ``rtgslam_torch`` against ``rtgslam_tpu`` on the same numpy
inputs.

Tolerances: 1e-6 absolute on float32 math whose operation order matches
(differences are last-bit rounding of transcendental functions); numpy
copies must be exactly equal.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgslam_tpu.utils import geometry as jgeo
from rtgslam_tpu.utils import sh as jsh
from rtgslam_torch.utils import geometry as tgeo
from rtgslam_torch.utils import sh as tsh

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-6


def _quats(n=257, seed=0):
    q = np.random.default_rng(seed).standard_normal((n, 4)).astype(np.float32)
    q[:3] = [[1, 0, 0, 0], [0, 0, 0, 0], [0, 1, 0, 0]]   # identity, zero, 180 deg
    return q


@pytest.mark.parametrize("fn", ["normalize", "quat_to_rotmat"])
def test_quaternion_math(fn):
    q = _quats()
    a = np.asarray(getattr(jgeo, fn)(jnp.asarray(q)))
    b = getattr(tgeo, fn)(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_quat_align_z_to():
    n = np.random.default_rng(1).standard_normal((300, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1e-8, 1]]  # degenerate rows
    a = np.asarray(jgeo.quat_align_z_to(jnp.asarray(n)))
    b = tgeo.quat_align_z_to(torch.from_numpy(n)).numpy()
    np.testing.assert_allclose(b, a, atol=ATOL)


@pytest.mark.parametrize("xi", [[0, 0, 0, 1, 2, 3], [0.1, -0.2, 0.05, 0.3, 0, -0.1],
                                [1e-9, 0, 0, 0.01, 0.02, 0.03], [2.5, 1.0, -0.7, 0, 0, 0]])
def test_exp_se3(xi):
    xi = np.asarray(xi, np.float32)
    a = np.asarray(jgeo.exp_se3(jnp.asarray(xi)))
    b = tgeo.exp_se3(torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(b, a, atol=ATOL)


def test_camera_helpers_are_copies():
    rng = np.random.default_rng(2)
    R = tgeo.rot_compare(np.eye(3), np.eye(3))
    assert R == jgeo.rot_compare(np.eye(3), np.eye(3))
    Rm = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    t = rng.standard_normal(3)
    assert np.array_equal(tgeo.world_to_view(Rm, t), jgeo.world_to_view(Rm, t))
    assert tgeo.fov2focal(1.1, 300) == jgeo.fov2focal(1.1, 300)
    assert tgeo.focal2fov(255.0, 300) == jgeo.focal2fov(255.0, 300)
    assert tgeo.trans_compare(t, 2 * t) == jgeo.trans_compare(t, 2 * t)


@pytest.mark.parametrize("batch", [(300,), (7, 30)])
def test_build_covariance(batch):
    """R S S^T R^T: the 3x3 products' sums may round in another order, so
    1e-6 of the largest entry (scales up to 0.5 m)."""
    rng = np.random.default_rng(len(batch))
    s = rng.uniform(0.01, 0.5, batch + (3,)).astype(np.float32)
    q = rng.standard_normal(batch + (4,)).astype(np.float32)
    a = np.asarray(jgeo.build_covariance(jnp.asarray(s), jnp.asarray(q)))
    b = tgeo.build_covariance(torch.from_numpy(s), torch.from_numpy(q)).numpy()
    assert b.shape == a.shape == batch + (3, 3)
    np.testing.assert_allclose(b, a, atol=1e-6 * np.abs(a).max())


@pytest.mark.parametrize("znear,zfar,fovx,fovy,degree", [
    (0.01, 100.0, 1.1, 0.8, 0), (0.1, 8.0, 1.5, 1.0, 1),
    (0.2, 1000.0, 0.6, 0.45, 3)])
def test_projection_matrix_and_num_sh_coeffs_are_copies(znear, zfar, fovx,
                                                        fovy, degree):
    """Host-side copies: exactly equal, numpy float32 as in JAX."""
    a = jgeo.projection_matrix(znear, zfar, fovx, fovy)
    b = tgeo.projection_matrix(znear, zfar, fovx, fovy)
    assert isinstance(b, np.ndarray) and b.dtype == a.dtype == np.float32
    assert np.array_equal(b, a)
    assert tsh.num_sh_coeffs(degree) == jsh.num_sh_coeffs(degree)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(degree):
    rng = np.random.default_rng(degree)
    sh = rng.standard_normal((200, 16, 3)).astype(np.float32)
    d = rng.standard_normal((200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a = np.asarray(jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(d)))
    td = torch.from_numpy(d)
    b = torch.stack(tsh.eval_sh_flat(degree, torch.from_numpy(sh).reshape(200, -1),
                                     td[:, 0], td[:, 1], td[:, 2]), dim=-1).numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)   # sums of 16 products of O(1)
    rgb = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))), atol=ATOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_stacked_and_sh_to_rgb(degree):
    """``eval_sh`` on the stacked [..., K, 3] layout, over batch dimensions,
    and ``sh_to_rgb`` against the JAX package's."""
    rng = np.random.default_rng(10 + degree)
    sh = rng.standard_normal((7, 30, 16, 3)).astype(np.float32)
    d = rng.standard_normal((7, 30, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    a = np.asarray(jsh.eval_sh(degree, jnp.asarray(sh), jnp.asarray(d)))
    b = tsh.eval_sh(degree, torch.from_numpy(sh), torch.from_numpy(d)).numpy()
    assert b.shape == a.shape == (7, 30, 3)
    np.testing.assert_allclose(b, a, atol=1e-5)   # sums of 16 products of O(1)
    np.testing.assert_allclose(tsh.sh_to_rgb(torch.from_numpy(sh[..., 0, :])).numpy(),
                               np.asarray(jsh.sh_to_rgb(jnp.asarray(sh[..., 0, :]))),
                               atol=ATOL)


def test_minicam_is_a_copy():
    from rtgslam_tpu.data import MiniCam as JMiniCam
    from rtgslam_torch.data import MiniCam

    rng = np.random.default_rng(3)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    w2c[:3, 3] = rng.standard_normal(3)
    for cx in (None, 61.5):
        kw = dict(width=128, height=96, FoVy=0.9, FoVx=1.1, znear=0.01,
                  zfar=100.0, w2c_matrix=w2c, cx=cx, cy=cx and 40.25)
        a, b = JMiniCam(**kw), MiniCam(**kw)
        assert (a.image_width, a.image_height) == (b.image_width, b.image_height)
        assert np.array_equal(a.intrinsic, b.intrinsic)
        got = b.device_dict()
        for k, v in a.device_dict().items():
            assert got[k].dtype == torch.float32
            assert np.array_equal(got[k].numpy(), v), k


def test_synthetic_cameras_are_copies():
    from rtgslam_tpu.data.synthetic import make_cameras as jmake
    from rtgslam_torch.data.synthetic import make_cameras as tmake

    for a, b in zip(jmake(3, 24, 32), tmake(3, 24, 32)):
        for f in ("R", "T", "image", "depth", "pose_gt", "intrinsic", "w2c", "c2w"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.FoVx, a.FoVy, a.cx, a.cy) == (b.FoVx, b.FoVy, b.cx, b.cy)
        d = b.device_dict()
        for k, v in a.device_dict().items():
            assert np.array_equal(d[k].numpy(), v), k


def test_ate_is_a_copy():
    from rtgslam_tpu.utils.traj import ate_rmse as jate
    from rtgslam_torch.utils.traj import ate_rmse as tate

    rng = np.random.default_rng(4)
    gt = rng.standard_normal((20, 3))
    es = gt + 0.01 * rng.standard_normal((20, 3))
    assert tate(es, gt) == jate(es, gt)


def test_make_args_matches_bench():
    """The port's ``make_args`` is ``bench.make_args(H, W,
    env_overrides=False)``, gradient-iteration counts included (the output
    path aside, and ``optimize_freeze_binning``, which bench reads from the
    environment and the port pins off)."""
    sys.path.insert(0, REPO)
    import bench
    from rtgslam_torch.slam.run import make_args

    for H, W in ((170, 300), (680, 1200)):
        want, _ = bench.make_args(H, W, env_overrides=False)
        got = vars(make_args(H, W))
        assert got["gaussian_update_iter"] == 50 and got["final_global_iter"] == 10
        assert got["optimize_freeze_binning"] is False
        for k, v in vars(want).items():
            if k not in ("save_path", "optimize_freeze_binning"):
                assert got[k] == v, k


def test_make_args_env_overrides_match_bench(monkeypatch):
    """With ``env_overrides`` the port's ``make_args`` takes bench.py's
    capacity and frozen-binning variables as ``bench.make_args`` does; the
    output path is ``bench_run`` in the temporary directory."""
    sys.path.insert(0, REPO)
    import bench
    from rtgslam_torch.slam.run import make_args

    for k, v in (("BENCH_MAP_CAPACITY", "65536"), ("BENCH_TEMP_CAPACITY", "8192"),
                 ("BENCH_TILE_CAPACITY", "128"), ("BENCH_BLOCK_CAPACITY", "2048"),
                 ("BENCH_FREEZE_BINNING", "1")):
        monkeypatch.setenv(k, v)
    want, _ = bench.make_args(96, 128)
    got = vars(make_args(96, 128, env_overrides=True))
    assert (got["map_capacity"], got["tile_capacity"], got["max_visible"]) \
        == (65536, 128, 32768)
    assert os.path.basename(got["save_path"]) == os.path.basename(want.save_path)
    for k, v in vars(want).items():
        if k != "save_path":
            assert got[k] == v, k
    assert vars(make_args(96, 128))["tile_capacity"] == 512
