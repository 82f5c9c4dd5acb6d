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
    ``tests/test_feature_track.py``;
  * the same pair bitwise (``assert_array_equal``) on ray-cast TUM-size
    frames, on sizes whose corner cells do not divide the frame, across a
    camera that changes size and with two backends interleaved: the port's
    corner pass streams over kept buffers where ``native/`` allocates full
    planes, and each of its scores is computed in the same order, so
    nothing may differ.
"""

import ctypes
import json
import os
import subprocess
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


def _scene_frames(n, H, W):
    """``n`` frames of the benchmark's room at H x W with the fr1_desk
    sensor and motion, as the backend takes them: colour u8 [H, W, 3],
    depth u16 [H, W] in the sensor's units, K and the ground-truth poses."""
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    import scene

    with open(os.path.join(REPO, "benchmark", "traffic", "fr1_desk.json")) as f:
        traffic = json.load(f)
    seq = scene.make_sequence(traffic["sensor"], traffic["motion"], H, W, n, "cpu")
    colour = [np.round(c * 255).astype(np.uint8) for c in seq["colour"]]
    depth = [np.round(d[..., 0] * seq["depth_scale"]).astype(np.uint16)
             for d in seq["depth"]]
    return colour, depth, seq["K"], seq["poses"], seq["depth_scale"]


@pytest.fixture(scope="module")
def tum_frames():
    return _scene_frames(7, 480, 640)


@pytest.fixture(scope="module")
def corner_probes(tmp_path_factory):
    """``tests/corner_probe.cc`` built twice with the port's flags: the
    port's corner pass and ``native/``'s, each a function (gray float32
    [H, W]) -> (u, v, score) arrays; and the two libraries."""
    out = tmp_path_factory.mktemp("corner_probe")
    src = os.path.join(REPO, "tests", "corner_probe.cc")
    probes, libs = [], []
    for name, defines in (("port", ["-DPORT"]), ("native", [])):
        path = str(out / f"libprobe_{name}.so")
        subprocess.run(["g++", *cuda_build.GXX_FLAGS, *defines, "-o", path, src],
                       check=True, capture_output=True)
        libs.append(ctypes.CDLL(path))
        fn = libs[-1].probe_corners
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        probes.append(fn)

    def corners(fn, gray):
        gray = np.ascontiguousarray(gray, np.float32)
        H, W = gray.shape
        cap = (W // 12 + 1) * (H // 12 + 1)
        u, v = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
        score = np.zeros(cap, np.float32)
        n = fn(gray.ctypes.data, W, H, cap, u.ctypes.data, v.ctypes.data,
               score.ctypes.data)
        assert n <= cap
        return u[:n], v[:n], score[:n]

    return [lambda gray, fn=fn: corners(fn, gray) for fn in probes], libs


def _gray(colour_u8):
    """The backend's gray of an rgb u8 frame (``to_gray``'s arithmetic)."""
    c = colour_u8.astype(np.float32)
    return ((np.float32(0.299) * c[..., 0] + np.float32(0.587) * c[..., 1]
             + np.float32(0.114) * c[..., 2]) / np.float32(255.0))


@pytest.mark.parametrize("H,W,source", [(480, 640, "tum"), (121, 163, "noise"),
                                        (37, 50, "noise"), (17, 20, "noise"),
                                        (16, 16, "noise"), (15, 40, "noise"),
                                        (64, 90, "tiles")])
def test_corner_pass_bitwise_native(corner_probes, tum_frames, H, W, source):
    """Every corner's (u, v, score) of the port's streaming pass is bitwise
    ``native/``'s full-plane one, in the same order, on ray-cast TUM frames,
    on noise at sizes whose cells do not divide the frame, and on 3-pixel
    tiles whose equal scores leave each cell's first maximum to win."""
    if source == "tum":
        grays = [_gray(c) for c in tum_frames[0][:3]]
    elif source == "tiles":
        y, x = np.mgrid[:H, :W]
        grays = [(0.25 + 0.5 * ((x // 3 + y // 3) % 2)).astype(np.float32)]
    else:
        rng = np.random.default_rng(H * W)
        grays = [rng.uniform(0, 1, (H, W)).astype(np.float32)
                 for _ in range(3)]
    port, native = corner_probes[0]
    for gray in grays:
        got, want = port(gray), native(gray)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert len(want[0]) > 0 or min(H, W) <= 16


def _wall_frames(H, W, n, step_px=2, seed=3):
    """``n`` views of a textured wall at 2 m, ``step_px`` apart along x."""
    pad = 8 + n * step_px
    tex = _texture(H, W, pad, seed)
    colour = [_u8(np.ascontiguousarray(
        tex[pad:pad + H, pad + i * step_px:pad + i * step_px + W]))
        for i in range(n)]
    depth = [np.full((H, W), 2000, np.uint16)] * n
    K = np.array([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]])
    tx = step_px * 2.0 / 100.0
    poses = [np.eye(4) for _ in range(n)]
    for i, p in enumerate(poses):
        p[0, 3] = tx * i
    return colour, depth, K, poses, 1000.0


def _steps(colour, depth, poses, bias=0.003):
    """The calls of one tracked sequence: the first frame, ICP steps (the
    true relative pose plus a bias along x, so the window refinement has
    work) and a feature track of the last frame alone."""
    steps = [("process_image_rgbd", (colour[0], depth[0], 0.0))]
    for i in range(1, len(colour) - 1):
        rel = np.linalg.inv(poses[i - 1]) @ poses[i]
        rel[0, 3] += bias
        steps.append(("track_with_icp_pose",
                      (colour[i], depth[i], rel.astype(np.float32), float(i))))
    steps.append(("track_with_orb_feature",
                  (colour[-1], depth[-1], float(len(colour) - 1))))
    return steps


def _start(be, K, W, H, scale, window_ba=True):
    be.initialize(True)
    be.set_window_ba(window_ba)
    be.set_camera(K, W, H, scale)


def _run(be, steps, reused=None):
    """Make the calls; record ``last_frame_reused`` after each image call
    into ``reused`` (the port's backend only) and return the trajectory and
    the feature track's outcome."""
    for name, call_args in steps:
        getattr(be, name)(*call_args)
        if reused is not None:
            reused.append(be.last_frame_reused())
    return (np.array(be.get_trajectory_points()), be.last_track_ok(),
            be.last_track_inliers())


def _bitwise_pair(lib, frames, window_ba=True):
    """The port's and JAX's libraries over the same calls: equal bit for
    bit, and every port call in its kept buffers."""
    colour, depth, K, poses, scale = frames
    H, W = depth[0].shape
    steps = _steps(colour, depth, poses)
    reused = []
    got, want = [], []
    for be, out, rec in ((tnative.NativePoseBackend(lib), got, reused),
                         (jnative.NativePoseBackend(JAX_LIB), want, None)):
        _start(be, K, W, H, scale, window_ba)
        out.extend(_run(be, steps, rec))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    assert reused == [True] * len(steps)
    return got


def test_native_tum_frames_bitwise_jax(lib, tum_frames):
    """Seven ray-cast 480x640 frames with fr1_desk's sensor: corners,
    matches, RANSAC and the windowed refinement all feed the trajectory."""
    traj, ok, inliers = _bitwise_pair(lib, tum_frames)
    assert len(traj) == 7 and ok and inliers >= 12


@pytest.mark.parametrize("H,W", [(121, 163), (17, 20), (16, 16)])
def test_native_odd_sizes_bitwise_jax(lib, H, W):
    """Frames whose 12-pixel corner cells do not divide them, one with a
    single row of cells, and the 16x16 frame that has none."""
    traj, ok, _ = _bitwise_pair(lib, _wall_frames(H, W, 8))
    assert len(traj) == 8 and ok == (H > 100)


@pytest.mark.parametrize("sizes,window_ba",
                         [(((121, 163), (96, 128)), True),
                          (((96, 128), (121, 163)), False)])
def test_native_camera_resize_bitwise_jax(lib, sizes, window_ba):
    """A camera that changes size mid-run: the kept buffers follow it and
    every call after each ``set_camera`` still allocates none.  (A larger
    frame beside window frames of the smaller one would have ``native/``
    read past them, so the growing case runs without the window.)"""
    runs = [_wall_frames(H, W, 6, seed=5 + k) for k, (H, W) in enumerate(sizes)]
    backends = (tnative.NativePoseBackend(lib), jnative.NativePoseBackend(JAX_LIB))
    reused, out = [], []
    for be in backends:
        be.initialize(True)
        be.set_window_ba(window_ba)
        for (colour, depth, K, poses, scale), (H, W) in zip(runs, sizes):
            be.set_camera(K, W, H, scale)
            out.append(_run(be, _steps(colour, depth, poses),
                            reused if be is backends[0] else None))
    half = len(out) // 2
    for got, want in zip(out[:half], out[half:]):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert out[half - 1][1] and len(reused) == 12 and all(reused)


def test_native_interleaved_backends_equal_solo(lib, tum_frames):
    """Two backends in one process, their calls interleaved: each equals its
    solo run bit for bit (they share no buffer)."""
    colour, depth, K, poses, scale = tum_frames
    wall = _wall_frames(121, 163, 7)
    seqs = [(_steps(colour, depth, poses), K, 640, 480, scale),
            (_steps(*wall[:2], wall[3]), wall[2], 163, 121, wall[4])]
    solo = []
    for steps, K_, W, H, sc in seqs:
        be = tnative.NativePoseBackend(lib)
        _start(be, K_, W, H, sc)
        solo.append(_run(be, steps))
    pair = [tnative.NativePoseBackend(lib) for _ in seqs]
    for be, (_, K_, W, H, sc) in zip(pair, seqs):
        _start(be, K_, W, H, sc)
    reused = []
    for a, b in zip(seqs[0][0], seqs[1][0]):
        for be, (name, call_args) in zip(pair, (a, b)):
            getattr(be, name)(*call_args)
            reused.append(be.last_frame_reused())
    for be, want in zip(pair, solo):
        got = (np.array(be.get_trajectory_points()), be.last_track_ok(),
               be.last_track_inliers())
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert all(reused) and len(reused) == 14


@pytest.mark.parametrize("H,W", [(480, 640), (121, 163)])
def test_zncc_bitwise_native(corner_probes, tum_frames, H, W):
    """Every pair's ZNCC score of the port (each patch's centred values and
    sum of squares once per corner, then a dot product) is bitwise
    ``native/``'s (both patches' sums for every pair), between the corners
    of two frames."""
    if H == 480:
        a, b = (_gray(c) for c in tum_frames[0][1:3])
    else:
        rng = np.random.default_rng(11)
        a = rng.uniform(0, 1, (H, W)).astype(np.float32)
        b = np.roll(a, 2, axis=1) + rng.normal(0, 0.05, (H, W)).astype(np.float32)
    a, b = (np.ascontiguousarray(x, np.float32) for x in (a, b))
    ua, va, _ = corner_probes[0][1](a)
    ub, vb, _ = corner_probes[0][1](b)
    ua, va, ub, vb = (np.ascontiguousarray(x[:60], np.int32) for x in (ua, va, ub, vb))
    assert len(ua) >= 30 and len(ub) >= 30
    scores = []
    for lib in corner_probes[1]:
        fn = lib.probe_zncc
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p]
        out = np.zeros((len(ua), len(ub)), np.float32)
        fn(a.ctypes.data, b.ctypes.data, W, H, ua.ctypes.data, va.ctypes.data,
           len(ua), ub.ctypes.data, vb.ctypes.data, len(ub), out.ctypes.data)
        scores.append(out)
    np.testing.assert_array_equal(scores[0], scores[1])
    assert np.abs(scores[1]).max() > 0.5
