"""Port parity: the pose backend (``rtgslam_torch/slam/pose_backend.py``,
``native_backend.py`` and its own copy of the C++ source,
``rtgslam_torch/csrc/pose_backend.cc``, built with g++ at first use)
against the JAX package's.

Tolerances, each with its reason:
  * ``relax_pose_graph`` and ``FakePoseBackend``: the same numpy code on the
    same float64 inputs, held to 1e-12;
  * the port's g++-built library against ``native/build/libpose_backend.so``
    through the JAX binding: the same C++ (compiler and flags may differ, so
    a last-bit difference is allowed), trajectories to 1e-9 — integration,
    the loop constraint, the windowed refinement and feature tracking on a
    known shift, the cases of ``tests/test_native_backend.py`` and
    ``tests/test_feature_track.py``.
"""

import os
import sys

import numpy as np
import pytest
import torch

from rtgslam_tpu.slam import native_backend as jnative
from rtgslam_tpu.slam import pose_backend as jpb
from rtgslam_tpu.slam.tracker import convert_poses as jconvert
from rtgslam_torch.slam import native_backend as tnative
from rtgslam_torch.slam import pose_backend as tpb
from rtgslam_torch.slam.tracker import convert_poses
from rtgslam_torch.utils import cuda_build

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_feature_track import _texture, _u8  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIB = os.path.join(REPO, "native", "build", "libpose_backend.so")


def _rel(t):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    return T


def _drifting_chain(n, seed=0):
    """Poses along a curve with rotation, and drifted estimates."""
    rng = np.random.default_rng(seed)
    gt, est = [], []
    for i in range(n):
        g = np.eye(4)
        g[:3, :3] = jpb._so3_exp(np.array([0.0, 0.03 * i, 0.01 * i]))
        g[:3, 3] = [0.05 * i, 0.01 * np.sin(i), 0.0]
        gt.append(g)
        e = g.copy()
        e[:3, 3] += [0.002 * i, 0.0, 0.0015 * i]
        e[:3, :3] = jpb._so3_exp(rng.normal(0, 0.002, 3)) @ e[:3, :3]
        est.append(e)
    return gt, est


def test_relax_pose_graph_equals_jax():
    gt, est = _drifting_chain(25)
    loops = [(0, 24, np.linalg.inv(gt[0]) @ gt[24], 5.0),
             (3, 20, np.linalg.inv(gt[3]) @ gt[20], 1.0)]
    want = jpb.relax_pose_graph(est, loops, iterations=60)
    got = tpb.relax_pose_graph(est, loops, iterations=60)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
    np.testing.assert_array_equal(got[0], est[0])    # gauge
    assert tpb.relax_pose_graph(est, []) is est


def test_fake_backend_equals_jax():
    gt, est = _drifting_chain(15, seed=1)
    fakes = (tpb.FakePoseBackend(), jpb.FakePoseBackend())
    for be in fakes:
        be.initialize(True)
        be.set_camera(np.eye(3), 8, 6, 1000.0)
        be.process_image_rgbd(None, None, 0.0)
        for i in range(1, 15):
            if i == 7:
                be.track_with_orb_feature(None, None, float(i))   # pose hold
            else:
                rel = np.linalg.inv(est[i - 1]) @ est[i]
                be.track_with_icp_pose(None, None, rel.astype(np.float32), float(i))
        be.add_loop_constraint(0, 14, np.linalg.inv(gt[0]) @ gt[14],
                               weight=5.0, iterations=100)
    for rows in ("get_trajectory_points", "get_keyframe_points"):
        a, b = (getattr(be, rows)() for be in fakes)
        np.testing.assert_allclose(np.array(a), np.array(b), atol=1e-12, rtol=0)
    assert len(fakes[0].get_keyframe_points()) == 2
    assert not fakes[0].last_track_ok() and fakes[0].last_track_inliers() == 0
    got, stamps = convert_poses(fakes[0].get_trajectory_points())
    want, _ = jconvert(fakes[1].get_trajectory_points())
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-12, rtol=0)
    assert stamps == [float(i) for i in range(15)]


@pytest.fixture(scope="module")
def lib():
    """The port's library, built here from its own source with g++."""
    path = cuda_build.build_host("pose_backend")
    assert os.path.basename(path).startswith("libpose_backend_")
    return path


def _pair(lib):
    """(port, JAX) native backends, initialized."""
    pair = (tnative.NativePoseBackend(lib), jnative.NativePoseBackend(JAX_LIB))
    for be in pair:
        be.initialize(True)
    return pair


def _trajectories_equal(pair):
    a, b = (np.array(be.get_trajectory_points()) for be in pair)
    assert a.shape == b.shape and len(a)
    np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
    return a


def test_native_integration_equals_jax(lib):
    pair = _pair(lib)
    for be in pair:
        be.process_image_rgbd(None, None, 0.0)
        be.track_with_icp_pose(None, None, _rel([0.01, 0, 0]), 1.0)
        be.track_with_icp_pose(None, None, _rel([0.01, 0.002, 0]), 2.0)
        be.track_with_orb_feature(None, None, 3.0)
    rows = _trajectories_equal(pair)
    poses, stamps = convert_poses(rows)
    assert stamps == [0.0, 1.0, 2.0, 3.0]
    np.testing.assert_allclose(poses[3][:3, 3], poses[2][:3, 3])   # hold
    a, b = (np.array(be.get_keyframe_points()) for be in pair)
    np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)


def test_native_loop_constraint_equals_jax(lib):
    pair = _pair(lib)
    n = 20
    T_true = np.eye(4)
    T_true[:3, 3] = [0.1 * (n - 1), 0, 0]
    for be in pair:
        be.process_image_rgbd(None, None, 0.0)
        for i in range(1, n):
            be.track_with_icp_pose(None, None, _rel([0.1 + 0.01, 0, 0]), float(i))
        be.add_loop_constraint(0, n - 1, T_true, weight=20.0, iterations=200)
    poses, _ = convert_poses(_trajectories_equal(pair))
    assert np.linalg.norm(poses[-1][:3, 3] - T_true[:3, 3]) < 0.3 * 0.19


@pytest.mark.parametrize("window_ba", [False, True])
def test_native_windowed_refinement_equals_jax(lib, window_ba):
    """Biased ICP steps over a textured wall (test_native_backend.py's
    windowed-refinement case), with and without the refinement."""
    H, W, fx, z, step_px, n = 120, 160, 100.0, 2.0, 2, 16
    tx, bias = step_px * z / fx, 0.012
    pad = 8 + n * step_px
    tex = _texture(H, W, pad)
    depth_u16 = np.full((H, W), int(z * 1000), np.uint16)
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]])
    pair = _pair(lib)
    for be in pair:
        be.set_camera(K, W, H, 1000.0)
        be.set_window_ba(window_ba)
        be.process_image_rgbd(_u8(tex[pad:pad + H, pad:pad + W]), depth_u16, 0.0)
        for i in range(1, n):
            img = _u8(np.ascontiguousarray(
                tex[pad:pad + H, pad + i * step_px:pad + i * step_px + W]))
            be.track_with_icp_pose(img, depth_u16, _rel([tx + bias, 0, 0]), float(i))
    poses, _ = convert_poses(_trajectories_equal(pair))
    est = np.array([p[0, 3] for p in poses])
    err = np.abs(est - tx * np.arange(n)).max()
    assert (err < 0.05) if window_ba else (err > 0.1)


@pytest.mark.parametrize("textured", [True, False])
def test_native_feature_track_equals_jax(lib, textured):
    """Feature tracking alone on a known 4-pixel shift of a textured plane
    (recovered) and on a featureless frame (refused, pose held)."""
    H, W, fx, z, shift, pad = 120, 160, 100.0, 2.0, 4, 16
    if textured:
        tex = _texture(H, W, pad)
        img0 = _u8(tex[pad:pad + H, pad:pad + W])
        img1 = _u8(np.ascontiguousarray(tex[pad:pad + H, pad + shift:pad + shift + W]))
    else:
        img0 = img1 = np.full((H, W, 3), 128, np.uint8)
    depth_u16 = np.full((H, W), int(z * 1000), np.uint16)
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]])
    pair = _pair(lib)
    for be in pair:
        be.set_camera(K, W, H, 1000.0)
        be.process_image_rgbd(img0, depth_u16, 0.0)
        be.track_with_orb_feature(img1, depth_u16, 1.0)
    assert pair[0].last_track_ok() == pair[1].last_track_ok() == textured
    assert pair[0].last_track_inliers() == pair[1].last_track_inliers()
    poses, _ = convert_poses(_trajectories_equal(pair))
    want_x = shift * z / fx if textured else 0.0
    assert abs(poses[-1][0, 3] - want_x) < 0.01


def test_native_refuses_wrong_frame_size(lib):
    be = tnative.NativePoseBackend(lib)
    be.initialize(True)
    be.set_camera(np.eye(3), 16, 8, 1000.0)
    with pytest.raises(ValueError, match="8x16"):
        be.process_image_rgbd(np.zeros((8, 15, 3), np.uint8),
                              np.zeros((8, 15), np.uint16), 0.0)
    with pytest.raises(ValueError, match="4x4"):
        be.track_with_icp_pose(None, None, np.eye(3), 1.0)


def test_create_backend_builds_or_raises(lib, tmp_path, monkeypatch):
    """``create_backend`` returns the native backend built from the port's
    source (never the fake); where it cannot be built it raises."""
    from rtgslam_torch.config import read_config

    args = read_config(os.path.join(REPO, "configs", "base.yaml"))
    be = tpb.create_backend(args)
    assert isinstance(be, tnative.NativePoseBackend)
    be.process_image_rgbd(None, None, 0.0)
    be.track_with_icp_pose(None, None, _rel([0.02, 0, 0]), 1.0)
    assert len(be.get_trajectory_points()) == 2

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tpb.create_backend(args)
