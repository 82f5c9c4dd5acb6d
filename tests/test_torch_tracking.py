"""Port parity: frame preprocessing, ICP pyramids and the fused ICP track
step against ``rtgslam_tpu`` on synthetic frames.

Tolerances: maps 1e-5 absolute (float32 Sobel / normalisation chains in
the same operation order), 5e-5 after the bilateral filter (81 exp-weighted
taps; XLA's and PyTorch's float32 exp differ by a few ulps); the tracked
pose 1e-4 (a 3-level, 15-step Gauss-Newton solve whose 7x7 normal
equations sum ~12k terms in another order).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgslam_tpu.config import read_config
from rtgslam_tpu.ops import icp as jicp
from rtgslam_tpu.slam import tracker as jtracker
from rtgslam_torch.ops import icp as ticp
from rtgslam_torch.slam import tracker as ttracker

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _args(**kw):
    args = read_config(os.path.join(REPO, "configs", "base.yaml"))
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


@pytest.mark.parametrize("use_filter", [False, True])
def test_preprocess_frame(synthetic_cams, use_filter):
    cam = synthetic_cams[1]
    K = cam.intrinsic
    want = jtracker.preprocess_frame(jnp.asarray(cam.depth), jnp.asarray(cam.image),
                                     jnp.asarray(K), 0.3, 8.0, 0.2, use_filter)
    got = ttracker.preprocess_frame(_t(cam.depth), _t(cam.image), _t(K),
                                    0.3, 8.0, 0.2, use_filter)
    for k, v in want.items():
        if v.dtype == bool:
            assert np.array_equal(got[k].numpy(), np.asarray(v)), k
        else:
            _close(got[k], v, atol=5e-5 if use_filter else ATOL)


def test_bilateral_filter_on_the_cpu_loads_no_library(monkeypatch):
    """A CPU tensor takes the plain loop: no kernel library is built or
    loaded, no launch is counted, and both depth layouts come back as
    given."""
    from rtgslam_torch.ops import preprocess
    from rtgslam_torch.utils import cuda_build

    def refuse(name):
        raise AssertionError(f"the CPU path loaded the library {name}")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    rng = np.random.default_rng(3)
    depth = (1.0 + rng.random((24, 40))).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0.0
    before = dict(preprocess.launches)
    for d in (_t(depth), _t(depth[..., None])):
        got = preprocess.bilateral_filter(d, 5, 2.0, 2.0)
        assert got.shape == d.shape
        assert torch.equal(got, preprocess.bilateral_filter_plain(d, 5, 2.0, 2.0))
    assert preprocess.launches == before


@pytest.mark.parametrize("use_filter", [True, False])
def test_staged_tracker_times_the_filter(synthetic_cams, monkeypatch, use_filter):
    """The staged tracker on the CPU records ``track.filter`` once a frame
    with the depth filter on and never ``track.filter_kernel`` (the kernel
    runs only on the card); with the filter off, neither."""
    import torch_parity as tp
    from rtgslam_torch.slam import pose_backend as tpb
    from rtgslam_torch.utils import perf

    monkeypatch.setattr(perf, "ENABLED", True)
    perf.reset()
    try:
        tr = ttracker.Tracker(_args(use_gt_pose=False, use_orb_backend=True,
                                    use_loop_closure=False,
                                    depth_filter=use_filter),
                              "cpu", orb_backend=tpb.FakePoseBackend())
        tr.orb_backend.initialize(True)
        assert not tr.fused
        for i, cam in enumerate(tp.port_cameras(synthetic_cams[:3])):
            tr.tracking(cam, tr.map_preprocess(cam, i))
        report = perf.report()
    finally:
        perf.reset()
    assert report["track.frame"]["count"] == 3
    assert report.get("track.filter", {}).get("count", 0) == (3 if use_filter else 0)
    assert "track.filter_kernel" not in report


def test_icp_pyramids_and_fusion(synthetic_cams):
    cam = synthetic_cams[2]
    K = cam.intrinsic
    jv, jn = jicp.build_icp_pyramids(jnp.asarray(cam.depth), jnp.asarray(K), 3)
    tv, tn = ticp.build_icp_pyramids(_t(cam.depth), _t(K), 3)
    for a, b in zip(tv + tn, jv + jn):
        _close(a, b)
    # model-depth fusion against a perturbed, partly empty "render"
    rng = np.random.default_rng(0)
    rd = cam.depth * (1 + 0.02 * rng.standard_normal(cam.depth.shape)).astype(np.float32)
    rd[:20] = 0.0
    rn = np.asarray(jn[-1])
    fn = np.roll(rn, 3, axis=1)
    want = jicp.fuse_model_depth(jnp.asarray(rd), jnp.asarray(cam.depth),
                                 jnp.asarray(rn), jnp.asarray(fn), 0.01, 0.01)
    got = ticp.fuse_model_depth(_t(rd), _t(cam.depth), _t(rn), _t(fn), 0.01, 0.01)
    _close(got, want)


def _track_pair(cams, use_model):
    """One fused ICP step tracking frame 1 against frame 0 in both
    packages; returns (port outputs, JAX outputs)."""
    args = _args(use_gt_pose=False, icp_use_model_depth=use_model)
    icp = jicp.IcpTracker(args)
    K = cams[0].intrinsic
    fm0 = jtracker.preprocess_and_lift(
        jnp.asarray(cams[0].depth), jnp.asarray(cams[0].image), jnp.asarray(K),
        jnp.eye(4), 0.3, 5.0, 0.2, False)
    t0_depth = np.asarray(fm0["depth_map"])
    render_n = np.asarray(fm0["normal_map_w"])
    render_d = t0_depth.copy()
    render_d[::7] = 0.0                          # holes the fusion fills
    statics = dict(
        min_depth=0.3, max_depth=5.0, confidence_thresh=0.2, use_filter=False,
        use_model=use_model, use_motion_model=icp.use_motion_model,
        downscales=tuple(icp.downscales), iters=tuple(icp.iters),
        association=icp.association, levels=icp.levels, damping=icp.damping,
        distance_threshold=icp.distance_threshold,
        normal_threshold=icp.normal_threshold,
        sample_distance_threshold=icp.sample_distance_threshold,
        sample_normal_threshold=icp.sample_normal_threshold,
        fail_threshold=icp.fail_threshold)
    c1 = cams[1]
    inputs = (c1.depth, c1.image, K, t0_depth, render_d, render_n, render_n,
              np.eye(4), np.eye(4))
    want = jtracker.fused_icp_track_step(
        *(jnp.asarray(np.asarray(x, np.float32)) for x in inputs),
        jnp.asarray(False), **statics)
    got = ttracker.fused_icp_track_step(*(_t(x) for x in inputs), False,
                                        **statics)
    return got, want


@pytest.mark.parametrize("use_model", [False, True])
def test_fused_icp_track_step(synthetic_cams, use_model):
    got, want = _track_pair(synthetic_cams, use_model)
    _close(got[1], want[1], atol=1e-4)            # c2w
    _close(got[3], want[3], atol=1e-4)            # new last_rel
    _close(got[4], want[4], atol=1e-6)            # p2p loss
    assert bool(got[5]) == bool(want[5])
    for k in ("depth_map", "vertex_map_w", "normal_map_w"):
        _close(got[0][k], want[0][k], atol=1e-4)


def test_icp_recovers_pose(synthetic_cams):
    """Twin of test_ops.py::test_icp_recovers_pose on the port's track step."""
    got, _ = _track_pair(synthetic_cams, use_model=False)
    pose10 = got[1].numpy()
    gt_rel = np.linalg.inv(synthetic_cams[0].pose_gt) @ synthetic_cams[1].pose_gt
    assert bool(got[5])
    assert np.linalg.norm(pose10[:3, 3] - gt_rel[:3, 3]) < 2e-3   # < 2 mm
    R_err = pose10[:3, :3].T @ gt_rel[:3, :3]
    ang = np.rad2deg(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    assert ang < 0.2


def test_tracker_refuses_unported_backends(synthetic_cams, monkeypatch):
    """Nothing is refused any more: the pose backend (the native one, built
    from the port's own source) and the pure-ICP loop closure construct and
    track; only a CUDA default with no card raises."""
    import torch_parity as tp

    for kw, fused in ((dict(use_orb_backend=True), False),
                      (dict(loop_closure_pure_icp=True), True)):
        tr = ttracker.Tracker(_args(use_gt_pose=False, **kw), "cpu")
        assert tr.fused == fused and tr.loop_closer is not None
        for i, cam in enumerate(tp.port_cameras(synthetic_cams[:3])):
            tr.tracking(cam, tr.map_preprocess(cam, i))
        assert len(tr.pose_es) == 3 and tr.eval_ate() < 1.0
    assert len(tr.get_new_poses() or []) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        ttracker.Tracker(_args(use_gt_pose=False))


@pytest.mark.parametrize("native", [True, False])
def test_staged_tracker_counts_reused_backend_calls(synthetic_cams, monkeypatch,
                                                    native):
    """With the native backend every ``track.backend`` call records the
    marker ``track.backend_reused`` (its frame buffers were sized at
    ``set_camera``); a fake without ``last_frame_reused`` records none."""
    import torch_parity as tp
    from rtgslam_torch.slam import pose_backend as tpb
    from rtgslam_torch.utils import perf

    monkeypatch.setattr(perf, "ENABLED", True)
    perf.reset()
    try:
        args = _args(use_gt_pose=False, use_orb_backend=True,
                     use_loop_closure=False)
        backend = tpb.create_backend(args) if native else tpb.FakePoseBackend()
        if not native:
            backend.initialize(True)
        tr = ttracker.Tracker(args, "cpu", orb_backend=backend)
        for i, cam in enumerate(tp.port_cameras(synthetic_cams[:3])):
            tr.tracking(cam, tr.map_preprocess(cam, i))
        report = perf.report()
    finally:
        perf.reset()
    assert report["track.backend"]["count"] == 3
    assert report.get("track.backend_reused", {}).get("count", 0) == (3 if native else 0)
