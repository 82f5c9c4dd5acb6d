"""Port parity: loop detection, relocalization and the staged tracking
path (``rtgslam_torch/slam/loop_closure.py``, ``slam/tracker.py``) against
the JAX package, on the out-and-back revisit of ``tests/test_loop_closure.py``
(96x128, 10 frames out and 9 back) and its strided orbit.

Tolerances, each with its reason:
  * descriptors 1e-6: float32 block means and norms in another order;
  * ``_verify``: T_ij 1e-4 and the residual 1e-3 relative, the ICP solve's
    tolerance (``test_torch_tracking.py``: 15 Gauss-Newton steps whose 7x7
    normal equations sum thousands of terms in another order);
  * whole tracker runs: each frame's pose within 1e-3 of JAX's (ICP's 1e-4
    per solve, accumulated over 19 frames and moved by the pose-graph
    relaxation), the same closures and relocalizations.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

from rtgslam_tpu.data.synthetic import make_cameras
from rtgslam_tpu.slam import Tracker as JTracker
from rtgslam_tpu.slam import loop_closure as jlc
from rtgslam_tpu.slam import pose_backend as jpb
from rtgslam_torch.slam import loop_closure as tlc
from rtgslam_torch.slam import pose_backend as tpb
from rtgslam_torch.slam import tracker as ttracker

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402
from test_loop_closure import (DriftingBackend, _drifting_fused_step,  # noqa: E402
                               _loop_sequence)

torch.set_num_threads(1)
POSE_ATOL = 1e-3
BIAS = [0.0015, 0, 0.001]


class PortDriftingBackend(tpb.FakePoseBackend):
    """The port's twin of ``test_loop_closure.py::DriftingBackend``: every
    odometry increment is corrupted by ``bias``."""

    def __init__(self, bias):
        super().__init__()
        self.bias = np.asarray(bias, np.float64)

    def track_with_icp_pose(self, color, depth, pose_rel, timestamp):
        p = np.asarray(pose_rel, np.float64).copy()
        p[:3, 3] += self.bias
        super().track_with_icp_pose(color, depth, p, timestamp)


@pytest.fixture(scope="module")
def loop_cams():
    return _loop_sequence(make_cameras(n_frames=10, H=96, W=128))


@pytest.fixture(scope="module")
def orbit_cams():
    return make_cameras(n_frames=24, H=96, W=128)[::3]


def _args(base_args, **kw):
    args = copy.deepcopy(base_args)
    args.use_gt_pose = False
    args.icp_use_model_depth = False
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _run(tracker, cams, fail_at=None):
    real = tracker.icp.predict_pose
    for i, cam in enumerate(cams):
        tracker.icp.predict_pose = (
            (lambda: (np.eye(4, dtype=np.float32), False)) if i == fail_at else real)
        fm = tracker.map_preprocess(cam, i)
        tracker.tracking(cam, fm)
    return tracker


def _same_run(got, want, n):
    assert len(got.pose_es) == len(want.pose_es) == n
    np.testing.assert_allclose(np.stack(got.pose_es), np.stack(want.pose_es),
                               atol=POSE_ATOL)
    for k in ("loops_closed", "relocalized"):
        assert got.status.get(k, 0) == want.status.get(k, 0), k
    assert abs(got.eval_ate() - want.eval_ate()) < 0.05


def test_descriptor_equals_jax(loop_cams):
    cam = loop_cams[3]
    depth = cam.depth[..., 0]
    np.testing.assert_allclose(tlc._descriptor(cam.image, depth),
                               jlc._descriptor(cam.image, depth), atol=1e-6)
    np.testing.assert_allclose(tlc._thumbnail(depth, 12, 16),
                               jlc._thumbnail(depth, 12, 16), atol=1e-6)


@pytest.mark.parametrize("seeds", [("est",), ("est", "identity")])
def test_verify_equals_jax(base_args, loop_cams, seeds):
    """``_verify`` between frame 3 and frame 16 (the revisit of frame 2, a
    neighbouring view), seeded from estimates 3 cm off."""
    args = _args(base_args)
    cand_cam, rec_cam = loop_cams[3], loop_cams[16]
    off = np.eye(4)
    off[:3, 3] = [0.03, -0.01, 0.0]

    def rec(cam, c2w):
        return {"id": cam.uid, "c2w": c2w, "depth": cam.depth[..., 0].copy()}

    cand, cur = rec(cand_cam, cand_cam.pose_gt), rec(rec_cam, rec_cam.pose_gt @ off)
    K = cand_cam.intrinsic
    T_j, p_j = jlc.LoopCloser(args)._verify(cand, cur, K, seeds)
    T_t, p_t = tlc.LoopCloser(args, "cpu")._verify(cand, cur, torch.from_numpy(K), seeds)
    np.testing.assert_allclose(T_t, T_j, atol=1e-4)
    assert abs(p_t - p_j) <= 1e-3 * abs(p_j)
    gt = np.linalg.inv(cand_cam.pose_gt) @ rec_cam.pose_gt
    assert np.abs(T_t[:3, 3] - gt[:3, 3]).max() < 5e-3


def test_tracker_loop_closure_matches_jax(base_args, loop_cams):
    """test_loop_closure.py::test_tracker_loop_closure_drops_ate in both
    packages: the staged backend path with a drifting fake backend closes
    the revisit, relaxes the graph and drops the ATE; the port's per-frame
    poses stay within 1e-3 of JAX's."""
    kw = dict(use_orb_backend=True, use_loop_closure=True, loop_check_every=1,
              loop_min_gap=14, loop_cooldown=50, loop_candidate_radius=0.4)
    jt = JTracker(_args(base_args, **kw), orb_backend=DriftingBackend(BIAS))
    jt.orb_backend.initialize(True)
    _run(jt, copy.deepcopy(loop_cams))
    args = _args(base_args, **kw)
    tt = ttracker.Tracker(args, "cpu", orb_backend=PortDriftingBackend(BIAS))
    assert not tt.fused and tt.loop_closer is not None
    tt.orb_backend.initialize(True)
    _run(tt, tp.port_cameras(loop_cams))
    _same_run(tt, jt, len(loop_cams))
    assert tt.status["loops_closed"] >= 1
    args.use_loop_closure = False
    t_open = ttracker.Tracker(args, "cpu", orb_backend=PortDriftingBackend(BIAS))
    t_open.orb_backend.initialize(True)
    _run(t_open, tp.port_cameras(loop_cams))
    assert tt.eval_ate() < 0.7 * t_open.eval_ate()
    assert len(tt.get_new_poses()) == len(loop_cams)   # every frame, backend


def test_relocalization_matches_jax(base_args, orbit_cams):
    """test_loop_closure.py::test_relocalization_recovers_from_icp_failure:
    a forced hard ICP failure at frame 5 relocalizes against the stored
    records in both packages, to the same pose."""
    kw = dict(use_orb_backend=True, use_loop_closure=True, loop_check_every=1,
              loop_min_gap=10 ** 6)
    jt = JTracker(_args(base_args, **kw), orb_backend=jpb.FakePoseBackend())
    jt.orb_backend.initialize(True)
    _run(jt, copy.deepcopy(orbit_cams), fail_at=5)
    tt = ttracker.Tracker(_args(base_args, **kw), "cpu",
                          orb_backend=tpb.FakePoseBackend())
    tt.orb_backend.initialize(True)
    _run(tt, tp.port_cameras(orbit_cams), fail_at=5)
    _same_run(tt, jt, len(orbit_cams))
    assert tt.status["relocalized"] == 1
    assert np.linalg.norm(tt.pose_es[5][:3, 3] - tt.pose_gt[5][:3, 3]) < 0.01


def _port_drifting_step(bias, fail_frames=()):
    """The port's twin of ``_drifting_fused_step``: a post-hoc odometry
    bias on the fused track step and forced hard failures."""
    orig = ttracker.fused_icp_track_step
    bias_T = torch.eye(4)
    bias_T[:3, 3] = torch.tensor(bias, dtype=torch.float32)
    garbage_T = torch.eye(4)
    garbage_T[:3, 3] = torch.tensor([0.12, 0, 0.08])
    calls = {"n": 0}

    def wrapper(*a, **k):
        fm, c2w, pose_used, new_last_rel, p2p, ok = orig(*a, **k)
        calls["n"] += 1
        if calls["n"] in fail_frames:
            return (fm, c2w @ garbage_T, pose_used, new_last_rel, p2p,
                    torch.tensor(False))
        return fm, c2w @ bias_T, pose_used, new_last_rel, p2p, ok

    return wrapper


@pytest.mark.parametrize("case", ["closure", "relocalization"])
def test_fused_pure_icp_matches_jax(base_args, loop_cams, orbit_cams,
                                    monkeypatch, case):
    """The fused pure-ICP path with ``loop_closure_pure_icp``
    (test_loop_closure.py's fused closure and relocalization cases): the
    drifting track step closes the revisit and the relaxed history goes to
    the mapper once; a forced failure relocalizes."""
    import rtgslam_tpu.slam.tracker as jtrmod

    if case == "closure":
        cams, bias, fails = loop_cams, BIAS, ()
        kw = dict(loop_min_gap=14, loop_cooldown=50, loop_candidate_radius=0.4)
    else:
        cams, bias, fails = orbit_cams, [0, 0, 0], {5}
        kw = dict(loop_min_gap=10 ** 6)
    kw.update(use_orb_backend=False, loop_closure_pure_icp=True,
              loop_check_every=1)
    jt = JTracker(_args(base_args, **kw))
    wrapper, _ = _drifting_fused_step(bias, fail_frames=fails)
    monkeypatch.setattr(jtrmod, "fused_icp_track_step", wrapper)
    _run(jt, copy.deepcopy(cams))
    tt = ttracker.Tracker(_args(base_args, **kw), "cpu")
    assert tt.fused and tt.loop_closer is not None
    monkeypatch.setattr(ttracker, "fused_icp_track_step",
                        _port_drifting_step(bias, fails))
    _run(tt, tp.port_cameras(cams))
    _same_run(tt, jt, len(cams))
    if case == "closure":
        assert tt.status["loops_closed"] >= 1
        poses, want = tt.get_new_poses(), jt.get_new_poses()
        np.testing.assert_allclose(np.stack(poses), np.stack(want), atol=POSE_ATOL)
        assert tt.get_new_poses() is None
    else:
        assert tt.status["relocalized"] >= 1
        assert np.linalg.norm(tt.pose_es[5][:3, 3] - tt.pose_gt[5][:3, 3]) < 0.01


def test_loop_store_reanchored_and_bounded(base_args):
    """The store adopts corrected poses, and thins itself at the cap
    (test_loop_closure.py's two store tests, on the port)."""
    lc = tlc.LoopCloser(_args(base_args), "cpu")
    lc.every, lc.min_gap = 1, 10 ** 9
    depth = np.ones((16, 16), np.float32)
    K = np.array([[10.0, 0, 8], [0, 10.0, 8], [0, 0, 1]], np.float32)
    for i in range(4):
        c2w = np.eye(4)
        c2w[0, 3] = 1.1 * i
        lc.observe(i, c2w, torch.from_numpy(depth)[..., None], K)
    corrected = [np.eye(4) for _ in range(4)]
    for i, c in enumerate(corrected):
        c[0, 3] = float(i)
    lc.update_poses(corrected)
    for rec in lc.records:
        np.testing.assert_array_equal(rec["c2w"], corrected[rec["id"]])
    lc = tlc.LoopCloser(_args(base_args), "cpu")
    lc.every, lc.max_records, lc.min_gap = 1, 16, 10 ** 9
    for i in range(200):
        if i % lc.every == 0:
            lc.observe(i, np.eye(4), depth[:8, :8], K)
    ids = [r["id"] for r in lc.records]
    assert len(ids) <= 16 and ids[-1] > 150 and ids[0] < 50


def test_staged_exports_match_jax(base_args, synthetic_cams, tmp_path):
    """The staged path's ``save_invalid_tracking`` (its ICP pyramids, once
    the pose drifts past the threshold) and ``save_traj`` (the backend's
    trajectory, then its shutdown) write what the JAX package writes."""
    kw = dict(use_orb_backend=True, use_loop_closure=False)
    jt = JTracker(_args(base_args, **kw), orb_backend=DriftingBackend(BIAS))
    tt = ttracker.Tracker(_args(base_args, **kw), "cpu",
                          orb_backend=PortDriftingBackend(BIAS))
    for tr, cams in ((jt, copy.deepcopy(synthetic_cams[:4])),
                     (tt, tp.port_cameras(synthetic_cams[:4]))):
        tr.orb_backend.initialize(True)
        _run(tr, cams)
    assert not tt.save_invalid_tracking(str(tmp_path / "port"), threshold=1.0)
    for tr, name in ((jt, "jax"), (tt, "port")):
        assert tr.save_invalid_tracking(str(tmp_path / name), threshold=1e-3)
    with np.load(tmp_path / "jax" / "invalid_tracking_4.npz") as want, \
            np.load(tmp_path / "port" / "invalid_tracking_4.npz") as got:
        assert sorted(got.files) == sorted(want.files) and len(got.files) == 12
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    ates = [tr.save_traj(str(tmp_path / name))
            for tr, name in ((jt, "jax"), (tt, "port"))]
    assert abs(ates[0] - ates[1]) < 0.01 and not tt.orb_backend._running
    for f in ("pose_es.npy", "pose_gt.npy"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / "save_traj" / f),
                                   np.load(tmp_path / "jax" / "save_traj" / f),
                                   atol=POSE_ATOL)
