"""Port parity: KNN, segment ops, the map lifecycle and ``MapState``
transport against ``rtgslam_tpu``.

Tolerances: slot assignment, status and integer counters EXACTLY equal;
KNN indices exactly equal, including ties, which both packages break to the
lowest index.  Float fields 1e-6 absolute where the float32 formulas match
op for op; 1e-5 on the history merge (XLA fuses its EMA into FMAs); 1e-3 on
spawned log-scales, which come from KNN distances |q|^2 + |r|^2 - 2 q.r of
metre-scale points at centimetre spacing, where float32 cancellation leaves
~1e-6 m^2 of rounding that the two dot-product orders resolve differently.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgslam_tpu.config import read_config
from rtgslam_tpu.models import map_ops as jops
from rtgslam_tpu.models.gaussian_map import (GaussianMapConfig, MapState as JMap,
                                             STABLE, UNSTABLE, render_inputs as jinputs,
                                             alive_mask as jalive, stable_mask as jstable)
from rtgslam_tpu.ops import knn as jknn
from rtgslam_tpu.ops import segment as jseg
from rtgslam_tpu.ops.rasterize import RasterSettings as JSettings
from rtgslam_tpu.ops.rasterize.api import render_model_and_stable as jrender_pair
from rtgslam_tpu.slam.tracker import preprocess_and_lift
from rtgslam_torch.models import map_ops as tops
from rtgslam_torch.models.gaussian_map import MapState as TMap
from rtgslam_torch.ops import knn as tknn
from rtgslam_torch.ops import segment as tseg
from rtgslam_torch.utils import threefry

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = [f.name for f in dataclasses.fields(TMap)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_state(state):
    return {f: np.asarray(getattr(state, f)) for f in FIELDS}


def _assert_states(got: TMap, want, atol=1e-6, field_atol=None):
    want = _np_state(want)
    for f, w in want.items():                    # integer fields first
        if w.dtype.kind in "iu":
            assert np.array_equal(getattr(got, f).numpy(), w), f
    for f, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(getattr(got, f).numpy(), w, err_msg=f,
                                       atol=(field_atol or {}).get(f, atol))


# ---------------------------------------------------------------------------
# KNN and segment ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,Q,R", [(3, 97, 500), (4, 200, 300), (4, 5, 3)])
def test_knn_ties_duplicates_invalid(k, Q, R):
    """As test_ops.py::test_knn_tournament_brute_force: duplicate points
    (exact ties within and across 128-lane segments), invalid refs, and
    fewer valid refs than k."""
    rng = np.random.default_rng(Q)
    q = rng.uniform(0, 2, (Q, 3)).astype(np.float32)
    r = rng.uniform(0, 2, (R, 3)).astype(np.float32)
    valid = np.ones(R, bool)
    if R > 200:
        r[120] = r[40]
        r[41] = r[40]
        q[3] = r[40]
        valid[rng.choice(R, 60, replace=False)] = False
        valid[[40, 41, 120]] = True
    else:
        valid[1] = False
    d_j, i_j = jknn.knn(jnp.asarray(q), jnp.asarray(r), jnp.asarray(valid),
                        k=k, chunk=256)
    d_t, i_t = tknn.knn(_t(q), _t(r), _t(valid), k=k)
    assert np.array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-5)
    dist = ((q[:, None] - r[None]) ** 2).sum(-1)
    dist[:, ~valid] = np.inf
    ref_i = np.argsort(dist, axis=1, kind="stable")[:, :k]
    ref_d = np.take_along_axis(dist, ref_i, axis=1)
    ref_i = np.where(np.isinf(ref_d), -1, ref_i)
    assert np.array_equal(i_t.numpy()[:, :ref_i.shape[1]], ref_i)
    assert np.all(i_t.numpy()[:, ref_i.shape[1]:] == -1)


@pytest.mark.parametrize("case", ["ties", "duplicates", "invalid", "few"])
def test_knn_self_matches_jax(case):
    """``knn_self`` (:198): the self column dropped, the mean over the
    finite neighbours; equal indices and means within 1e-5 of JAX's, on
    points at exact tie distances (a unit grid), duplicated points, invalid
    rows and fewer valid points than k + 1."""
    rng = np.random.default_rng(len(case))
    if case == "ties":
        g = np.arange(4, dtype=np.float32)
        pts = np.stack(np.meshgrid(g, g, g[:2], indexing="ij"), -1).reshape(-1, 3)
    else:
        pts = rng.uniform(0, 2, (150, 3)).astype(np.float32)
    valid = np.ones(len(pts), bool)
    if case == "duplicates":
        pts[[7, 60, 61]] = pts[30]
    elif case == "invalid":
        valid[rng.choice(len(pts), 40, replace=False)] = False
    elif case == "few":
        valid[3:] = False
    d_j, i_j = jknn.knn_self(jnp.asarray(pts), jnp.asarray(valid), k=3)
    d_t, i_t = tknn.knn_self(_t(pts), _t(valid), k=3)
    assert np.array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-6)
    assert np.all(np.isfinite(d_t.numpy()))
    if case == "few":
        assert np.all(i_t.numpy()[:3, 2] == -1)


def test_knn_respects_validity():
    q = torch.tensor([[0.0, 0, 0]])
    r = torch.tensor([[0.1, 0, 0], [0.2, 0, 0], [5, 5, 5]])
    d2, idx = tknn.knn(q, r, torch.tensor([False, True, True]), k=2)
    assert idx.tolist() == [[1, 2]]


def test_segment_ops():
    rng = np.random.default_rng(5)
    H, W, P = 12, 16, 40
    cidx = rng.integers(-1, P, (H, W)).astype(np.int32)
    didx = rng.integers(-1, P, (H, W)).astype(np.int32)
    errs = [rng.random((H, W)).astype(np.float32) for _ in range(3)]
    want = jseg.accumulate_gaussian_error(*map(jnp.asarray, errs),
                                          jnp.asarray(cidx), jnp.asarray(didx), P)
    got = tseg.accumulate_gaussian_error(*map(_t, errs), _t(cidx), _t(didx), P)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for n in (1, 7, 1000):
        mask = rng.random(n) < 0.4
        assert np.array_equal(tseg.stable_partition_order(_t(mask)).numpy(),
                              np.asarray(jseg.stable_partition_order(jnp.asarray(mask))))


# ---------------------------------------------------------------------------
# map state and lifecycle
# ---------------------------------------------------------------------------

CFG = GaussianMapConfig(capacity=4096, temp_capacity=2048, max_sh_degree=3,
                        init_opacity=0.99, min_radius=0.001, max_radius=0.05,
                        xyz_factor=(1.0, 1.0, 0.1))
SCALE_ATOL = {"scaling": 1e-3}
SPAWN = dict(uniform_sample_num=1500, transmission_sample_ratio=1.0,
             error_sample_ratio=0.05, add_transmission_thres=0.5,
             add_depth_thres=0.1, add_color_thres=0.1)


def _frame(cam):
    fm = preprocess_and_lift(jnp.asarray(cam.depth), jnp.asarray(cam.image),
                             jnp.asarray(cam.intrinsic),
                             jnp.asarray(cam.c2w, jnp.float32), 0.3, 8.0, 0.2, False)
    return fm, cam.device_dict()


def _spawn_both(key, jstate, tstate, fm, dd, model, first_frame, has_stable, time):
    """jops.spawn_step from ``key`` and tops.spawn_step fed the priorities
    that key yields (map_ops.py:438,65)."""
    H, W = fm["depth_map"].shape[:2]
    k1, k2 = jax.random.split(key)
    pr = (_t(jax.random.uniform(k1, (H * W,))), _t(jax.random.uniform(k2, (H * W,))))
    maps = (fm["vertex_map_w"], fm["normal_map_w"], fm["color_map"], fm["depth_map"])
    jstate, n_j, _ = jops.spawn_step(
        key, jstate, *maps, *model, jnp.asarray(dd["w2c"]), jnp.asarray(dd["K"]),
        time, *SPAWN.values(), CFG, CFG.temp_capacity // 2, H, W, first_frame,
        has_stable, CFG.capacity)
    n_t = tops.spawn_step(
        pr, tstate, *map(_t, maps), *map(_t, model), _t(dd["w2c"]), _t(dd["K"]),
        time, **SPAWN, config=CFG, max_each=CFG.temp_capacity // 2, height=H,
        width=W, first_frame=first_frame, has_stable=has_stable)
    assert n_t == int(n_j)
    return jstate


def test_spawn_step_identical_priorities(synthetic_cams):
    """First-frame spawn, then a later spawn with model renders, dedup
    against unstable rows and attach against stable ones."""
    cams = synthetic_cams
    H, W = cams[0].image.shape[:2]
    zero = (jnp.zeros((H, W, 1)), jnp.zeros((H, W, 1)), jnp.zeros((H, W, 3)),
            jnp.full((H, W), -1, jnp.int32), jnp.full((H, W), -1, jnp.int32))
    jstate = JMap.create(CFG)
    tstate = TMap.create(CFG)
    fm, dd = _frame(cams[0])
    jstate = _spawn_both(jax.random.PRNGKey(7), jstate, tstate, fm, dd, zero,
                         True, False, 0)
    _assert_states(tstate, jstate, field_atol=SCALE_ATOL)

    # promote every third alive gaussian so frame 2's spawn attaches
    status = np.asarray(jstate.status).copy()
    alive = np.nonzero(status)[0]
    status[alive[::3]] = STABLE
    jstate = jstate.replace(status=jnp.asarray(status))
    tstate.status.copy_(_t(status))
    fm, dd = _frame(cams[2])
    settings = JSettings(height=H, width=W, tile_capacity=1024)
    out, scidx, _ = jrender_pair(jinputs(jstate, jalive(jstate)), jstable(jstate),
                                 jnp.asarray(dd["w2c"]), jnp.asarray(dd["K"]),
                                 jnp.asarray(dd["campos"]), settings)
    model = (out["T_map"], out["depth"], out["render"], out["depth_index_map"], scidx)
    jstate = _spawn_both(jax.random.PRNGKey(8), jstate, tstate, fm, dd, model,
                         False, True, 2)
    _assert_states(tstate, jstate, field_atol=SCALE_ATOL)


def _random_state(seed=0, P=512):
    rng = np.random.default_rng(seed)
    st = _np_state(JMap.create(dataclasses.replace(CFG, capacity=P)))
    st["status"] = rng.integers(0, 3, P).astype(np.int32)
    st["xyz"] = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    st["features_dc"] = rng.standard_normal((P, 3)).astype(np.float32)
    st["features_rest"] = 0.1 * rng.standard_normal((P, 15, 3)).astype(np.float32)
    st["scaling"] = rng.uniform(-6, -3, (P, 3)).astype(np.float32)
    st["scaling"][:4] = -0.5                     # a few oversized gaussians
    st["rotation"] = rng.standard_normal((P, 4)).astype(np.float32)
    st["opacity"] = rng.standard_normal((P, 1)).astype(np.float32)
    st["confidence"] = rng.uniform(0, 150, (P, 1)).astype(np.float32)
    st["add_tick"] = rng.integers(0, 10, (P, 1)).astype(np.int32)
    st["depth_error_counter"] = rng.integers(0, 10, (P, 1)).astype(np.int32)
    st["color_error_counter"] = rng.integers(0, 10, (P, 1)).astype(np.int32)
    return st


def test_map_state_numpy_round_trip():
    st = _random_state()
    tstate = TMap.from_numpy(st)
    back = tstate.to_numpy()
    jstate = JMap(**{k: jnp.asarray(v) for k, v in back.items()})
    for f in FIELDS:
        assert back[f].dtype == st[f].dtype, f
        assert np.array_equal(back[f], st[f]), f
        assert np.array_equal(np.asarray(getattr(jstate, f)), st[f]), f


def test_lifecycle_step_strikes_and_deletes():
    """Stable rows near 10 strikes get deleted / released, confident
    unstable rows are promoted, old and oversized unstable rows freed."""
    P, H, W = 512, 24, 32
    st = _random_state(1, P)
    rng = np.random.default_rng(2)
    render_color = rng.random((H, W, 3)).astype(np.float32)
    render_depth = rng.uniform(0.5, 3, (H, W, 1)).astype(np.float32)
    gt_color = rng.random((H, W, 3)).astype(np.float32)
    gt_depth = (render_depth + rng.uniform(-0.1, 0.6, (H, W, 1))).astype(np.float32)
    gt_depth[:2] = 0.0
    didx = rng.integers(-1, P, (H, W)).astype(np.int32)
    cidx = rng.integers(-1, P, (H, W)).astype(np.int32)
    normal = np.zeros((H, W, 3), np.float32)
    thres = (100.0, 0.1, 0.1)                    # confidence, color, depth
    time, window = 130, 120.0
    st["add_tick"][::5] = 0                      # past the time window
    want = jops.lifecycle_step(
        JMap(**{k: jnp.asarray(v) for k, v in st.items()}),
        *map(jnp.asarray, (render_color, render_depth, normal, didx, cidx,
                           gt_color, gt_depth)), *thres, time, window, P)
    got = TMap.from_numpy(st)
    tops.lifecycle_step(got, *map(_t, (render_color, render_depth, didx, cidx,
                                       gt_color, gt_depth)), *thres, time, window)
    _assert_states(got, want)
    before, after = st["status"], np.asarray(want.status)
    assert ((before == STABLE) & (after == 0)).any()          # strike delete
    assert ((before == UNSTABLE) & (after == STABLE)).any()   # promotion
    assert ((before == UNSTABLE) & (after == 0)).any()        # unstable delete


def test_history_merge():
    st = _random_state(3)
    rng = np.random.default_rng(4)
    hist_src = dict(st)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation"):
        hist_src[f] = (st[f] + 0.05 * rng.standard_normal(st[f].shape)).astype(np.float32)
    hist_src["rotation"][:8] *= -1.0             # antipodal history quaternions
    # confidence only grows during an optimization pass, so the snapshot's
    # is at most the current one and the merge weight stays in [0, 0.5]
    hist_src["confidence"] = (st["confidence"] * rng.uniform(
        0, 1, st["confidence"].shape)).astype(np.float32)
    mask = rng.random(st["status"].shape[0]) < 0.7
    jhist = jops.capture_history(JMap(**{k: jnp.asarray(v) for k, v in hist_src.items()}))
    want = jops.history_merge(JMap(**{k: jnp.asarray(v) for k, v in st.items()}),
                              jhist, 0.5, jnp.asarray(mask))
    got = TMap.from_numpy(st)
    thist = tops.capture_history(TMap.from_numpy(hist_src))
    tops.history_merge(got, thist, 0.5, _t(mask))
    _assert_states(got, want, atol=1e-5)


def test_threefry_replays_jax_random():
    """utils/threefry.py reproduces the JAX mapper's priority stream bit
    for bit (split + uniform of PRNGKey(2024))."""
    src = threefry.jax_priorities()
    key = jax.random.PRNGKey(2024)
    for i, n in enumerate((1, 513, 12289)):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        pa, pb = src(i, n)
        assert np.array_equal(pa.numpy(), np.asarray(jax.random.uniform(k1, (n,))))
        assert np.array_equal(pb.numpy(), np.asarray(jax.random.uniform(k2, (n,))))


def test_mapper_refuses_gradient_iterations(monkeypatch):
    """Gradient iterations and the frozen binning of
    ``optimize_freeze_binning`` construct; the multi-chip mesh
    (``multi_device``, ROADMAP "Do not port") is refused; the default device
    is CUDA, which raises where there is none."""
    from rtgslam_torch.slam.mapper import Mapper

    args = read_config(os.path.join(REPO, "configs", "base.yaml"))
    args.map_capacity, args.temp_capacity = 1024, 256
    assert int(args.gaussian_update_iter) > 0 and int(args.final_global_iter) > 0
    Mapper(args, "cpu")
    args.optimize_freeze_binning = True
    assert Mapper(args, "cpu").freeze_binning
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        Mapper(args)
    args.multi_device = True
    with pytest.raises(NotImplementedError, match="multi_device"):
        Mapper(args, "cpu")
