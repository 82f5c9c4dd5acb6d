"""Port parity: the gradient optimization (``models/optimize.py``) against
``rtgslam_tpu``'s on ``parallel.sharded._tiny_problem`` (256 slots, 64
alive, 32x32, 2 frames), with rows 0-31 stable and 32-63 unstable, random
confidences and random frame colors and depths from numpy seeds.

Tolerances, each with its reason:
  * ``optimize_prepare``: masks, tile masks, lists, counts, pool and tile
    orders exactly equal — the transmission mask ``T != 1`` is exact and
    binning is integer work on identically rounded geometry;
  * the loss and its gradient at iteration 0: loss rtol 1e-5, gradients
    rtol 1e-4 with an absolute floor of 1e-4 of each group's largest
    gradient (per-pixel terms summed in another order; measured below 1e-5
    relative on the CPU);
  * ``_adam_step`` on identical inputs: rtol 1e-6 (float32 pow of the bias
    corrections may differ by an ulp between XLA and torch);
  * after several iterations: Adam with eps 1e-15 moves a row by about lr
    on the first step whatever its gradient's size, so a gradient that is
    rounding noise on one side would move its row a full lr either way.
    On this problem (flat discs, every gradient well above rounding noise)
    the parameters stayed within 2.4e-7 of JAX's after 5 iterations and the
    confidence counts were equal (measured on the CPU, torch 2.13, jax 0.9):
    parameters are held to 1e-5 absolute (lr is 1e-3, so one flipped step
    fails), reports to rtol 1e-5, confidences exactly.  With round discs
    (equal scales) the attach loss alone differed by 4 % after 5 iterations,
    the noise case above (ROADMAP.md, Faults).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtgslam_tpu.models import optimize as jopt
from rtgslam_tpu.models.gaussian_map import STABLE
from rtgslam_tpu.parallel.sharded import _tiny_problem
from rtgslam_torch.models import map_ops as tmap_ops
from rtgslam_torch.models import optimize as topt
from rtgslam_torch.models.gaussian_map import MapState
from rtgslam_torch.ops.rasterize import api as tapi

torch.set_num_threads(1)
LR = 1e-3
FRAME_KEYS = ("color", "depth", "normal", "w2c", "K", "campos")


@pytest.fixture(scope="module")
def problem():
    jstate, frames, jst = _tiny_problem(n_frames=2)
    rng = np.random.default_rng(11)
    P = jstate.capacity
    conf = np.zeros((P, 1), np.float32)
    conf[:64, 0] = rng.integers(0, 6, 64)
    # flat discs facing the camera, so opaque depth hits pass the normal gate
    scaling = np.asarray(jstate.scaling).copy()
    scaling[:64, 2] = np.log(0.02)
    jstate = jstate.replace(status=jstate.status.at[:32].set(STABLE),
                            confidence=jnp.asarray(conf),
                            scaling=jnp.asarray(scaling))
    color = rng.uniform(0.1, 0.9, frames.color.shape).astype(np.float32)
    depth = rng.uniform(1.8, 2.6, frames.depth.shape).astype(np.float32)
    depth[:, :4] = 0.0
    arrays = {"color": color, "depth": depth,
              "normal": np.asarray(frames.normal), "w2c": np.asarray(frames.w2c),
              "K": np.asarray(frames.K), "campos": np.asarray(frames.campos)}
    fields = {f.name: getattr(jst, f.name)
              for f in dataclasses.fields(tapi.RasterSettings)}
    return jstate, arrays, jst, tapi.RasterSettings(**fields)


def _port_state(jstate):
    return MapState.from_numpy({f.name: np.asarray(getattr(jstate, f.name))
                                for f in dataclasses.fields(MapState)})


def _jframes(arrays):
    return tuple(jnp.asarray(arrays[k]) for k in FRAME_KEYS)


def _tframes(arrays):
    return tuple(torch.from_numpy(arrays[k].copy()) for k in FRAME_KEYS)


def _weights(depth_weight=1.0):
    return {"color_weight": 0.8, "depth_weight": depth_weight,
            "normal_weight": 0.1, "add_depth_thres": 0.1}


def _jweights(w):
    return {k: jnp.float32(v) for k, v in w.items()}


LRS = {k: LR for k in topt.PARAM_KEYS}


def _bucket(n, floor, cap):
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


@pytest.mark.parametrize("mode,ratio", [("local", -1.0), ("global", -1.0),
                                        ("global", 0.4)])
def test_prepare_matches(problem, mode, ratio):
    jstate, arrays, jst, tst = problem
    want = jopt.optimize_prepare(jstate, *_jframes(arrays), settings=jst,
                                 mode=mode, sample_ratio=ratio,
                                 mask_depth_positive=True)
    got = topt.optimize_prepare(_port_state(jstate), *_tframes(arrays), tst,
                                mode, ratio, True)
    for name, w in zip(topt.Prepared._fields, want):
        g = getattr(got, name)
        g = g.numpy() if torch.is_tensor(g) else g
        assert np.array_equal(g, np.asarray(w)), name
    assert got.n_pool == (64 if mode == "local" else 32)
    assert got.rmasks.any() and got.n_live_tiles > 0


def _compact(state, arrays, tst, mode, weights):
    prep = topt.optimize_prepare(state, *_tframes(arrays), tst, mode, 0.4,
                                 False)
    hist = tmap_ops.capture_history(state)
    Ac, Tc = prep.n_pool, prep.n_live_tiles
    cp = topt.compact_problem(
        state, *_tframes(arrays), prep.rmasks, prep.lists_orig, prep.counts,
        prep.pool_order[:Ac], prep.n_pool, prep.tile_order[:, :Tc], weights,
        hist, tst, mode,
        topt.list_crop(prep.cnt_max, prep.lists_orig.shape[-1]))
    return prep, cp


@pytest.mark.parametrize("mode,frame", [("local", 0), ("global", 1)])
def test_compact_loss_gradient_matches(problem, mode, frame):
    """``_loss_fn_compact`` and its gradient at iteration 0 on identical
    compact inputs (those the port's ``compact_problem`` builds)."""
    jstate, arrays, jst, tst = problem
    prep, cp = _compact(_port_state(jstate), arrays, tst, mode, _weights())
    aux = {"update_mask": cp.update, "row_valid": cp.row_valid}
    tframe = dict({k: x[frame] for k, x in cp.frames.items()},
                  n_tiles_full=prep.counts.shape[1])
    leaves = {k: p.clone().requires_grad_(True) for k, p in cp.params.items()}
    loss, report = topt._loss_fn_compact(leaves, aux, tframe, tst, cp.hyper)
    report = {k: x.detach() for k, x in report.items()}
    grads = torch.autograd.grad(loss, [leaves[k] for k in topt.PARAM_KEYS])

    def j(x):
        return jnp.asarray(x.numpy()) if torch.is_tensor(x) else x

    jhyper = {k: jnp.float32(v) if isinstance(v, float) else j(v)
              for k, v in cp.hyper.items()}
    n_tiles_full = tframe.pop("n_tiles_full")

    def jax_loss(params, aux, frame):
        return jopt._loss_fn_compact(
            params, aux, dict(frame, n_tiles_full=n_tiles_full), jst, jhyper)

    (jloss, jreport), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(
        {k: j(v) for k, v in cp.params.items()},
        {k: j(v) for k, v in aux.items()},
        {k: j(v) for k, v in tframe.items()})
    assert float(report["color"]) > 0 and float(report["depth"]) > 0
    assert float(report["normal"]) > 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in topt.REPORT_KEYS:
        np.testing.assert_allclose(float(report[k]), float(jreport[k]),
                                   rtol=1e-5, atol=1e-7)
    for k, g in zip(topt.PARAM_KEYS, grads):
        want = np.asarray(jgrads[k])
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max() + 1e-12,
                                   err_msg=k)
    assert np.abs(np.asarray(jgrads["xyz"])).max() > 0


def test_adam_step_matches():
    rng = np.random.default_rng(3)
    shapes = {"xyz": (40, 3), "features_dc": (40, 3),
              "features_rest": (40, 15, 3), "scaling": (40, 3),
              "rotation": (40, 4), "opacity": (40, 1)}
    arr = {name: {k: rng.standard_normal(s).astype(np.float32)
                  for k, s in shapes.items()} for name in ("p", "g", "m")}
    arr["v"] = {k: np.abs(x) for k, x in arr["m"].items()}
    arr["g"]["xyz"][:5] = 0.0
    mask = rng.uniform(size=40) < 0.7
    lrs = {k: 10.0 ** -(i + 2) for i, k in enumerate(topt.PARAM_KEYS)}
    for step in (0, 3):
        want = jopt._adam_step(
            *({k: jnp.asarray(x) for k, x in arr[n].items()}
              for n in ("p", "g", "m", "v")),
            jnp.int32(step), {k: jnp.float32(v) for k, v in lrs.items()},
            jnp.asarray(mask))
        got = topt._adam_step(
            *({k: torch.from_numpy(x) for k, x in arr[n].items()}
              for n in ("p", "g", "m", "v")),
            step, lrs, torch.from_numpy(mask))
        for w, g in zip(want, got):
            for k in topt.PARAM_KEYS:
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           rtol=1e-6, atol=1e-9)


def _compare_states(got: MapState, want):
    for k in topt.PARAM_KEYS:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-5,
                                   err_msg=k)
    for k in ("confidence", "status"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k


def _compare_reports(got, want):
    for k in topt.REPORT_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)


def test_optimize_execute_matches(problem):
    """Five local iterations of the compact loop plus the history merge:
    the JAX side with its power-of-two buckets, the port with exact sizes."""
    jstate, arrays, jst, tst = problem
    n_iters, seq = 5, np.array([0, 1, 0, 1, 1])
    (rmasks, _, lists_orig, counts, pool_order, tile_order, n_pool, cnt_max,
     n_live) = jopt.optimize_prepare(jstate, *_jframes(arrays), settings=jst,
                                     mode="local", sample_ratio=-1.0,
                                     mask_depth_positive=False)
    P, T_full = jstate.capacity, counts.shape[1]
    Ac = _bucket(int(n_pool), 256, P)
    Ktc = _bucket(int(cnt_max), 64, lists_orig.shape[-1])
    Tc = _bucket(int(n_live), 32, T_full)
    want_state, want_report = jopt.optimize_execute(
        jstate, *_jframes(arrays), rmasks, lists_orig, counts,
        pool_order[:Ac], n_pool, tile_order[:, :Tc], jnp.asarray(seq),
        n_iters, {k: jnp.float32(v) for k, v in LRS.items()},
        _jweights(_weights()), jst, mode="local", max_weight=0.5, Ac=Ac,
        Ktc=Ktc, Tc=Tc)

    state = _port_state(jstate)
    prep = topt.optimize_prepare(state, *_tframes(arrays), tst, "local", -1.0,
                                 False)
    report = topt.optimize_execute(
        state, *_tframes(arrays), prep.rmasks, prep.lists_orig, prep.counts,
        prep.pool_order[:prep.n_pool], prep.n_pool,
        prep.tile_order[:, :prep.n_live_tiles], seq, n_iters, LRS, _weights(),
        tst, "local", 0.5,
        topt.list_crop(prep.cnt_max, prep.lists_orig.shape[-1]))
    _compare_reports(report, want_report)
    _compare_states(state, want_state)
    moved = np.abs(state.xyz.numpy() - np.asarray(jstate.xyz)).sum(-1) > 0
    assert moved[32:64].all() and not moved[:32].any()   # unstable rows only
    assert (state.confidence.numpy() > np.asarray(jstate.confidence)).any()


def test_optimize_chain_global_matches(problem):
    """The full-render loop of a global pass with the top-40 % color-error
    tile masks (``optimize_chain``, ``sample_ratio=0.4``)."""
    jstate, arrays, jst, tst = problem
    n_iters, seq = 4, np.array([1, 0, 1, 1])
    weights = _weights(depth_weight=0.5)
    want_state, want_report = jopt.optimize_chain(
        jstate, *_jframes(arrays), jnp.asarray(seq), n_iters,
        {k: jnp.float32(v) for k, v in LRS.items()}, _jweights(weights), jst,
        mode="global", sample_ratio=0.4, mask_depth_positive=False,
        max_weight=0.0)
    state = _port_state(jstate)
    report = topt.optimize_chain(state, *_tframes(arrays), seq, n_iters, LRS,
                                 weights, tst, "global", 0.4, False, 0.0)
    _compare_reports(report, want_report)
    _compare_states(state, want_state)
    moved = np.abs(state.features_dc.numpy()
                   - np.asarray(jstate.features_dc)).sum(-1) > 0
    assert moved[:32].any() and not moved[32:].any()     # stable rows only


@pytest.mark.parametrize("pool", ["alive", "stable"])
def test_render_fixed_binning_matches(problem, pool):
    """``render_fixed_binning`` (:426) over the same frozen order and tile
    lists (the port's ``_frozen_bins``, under frame 0's tile mask): every
    output within 1e-5, index maps equal; and the gradient of a color +
    depth loss through it within the compact test's tolerances."""
    from rtgslam_tpu.models.gaussian_map import (
        alive_mask as jalive, render_inputs as jrender_inputs,
        stable_mask as jstable)
    from rtgslam_tpu.ops.rasterize.api import render_fixed_binning as jfixed
    from rtgslam_torch.models.gaussian_map import (alive_mask, render_inputs,
                                                   stable_mask)

    jstate, arrays, jst, tst = problem
    state = _port_state(jstate)
    mask = (alive_mask if pool == "alive" else stable_mask)(state)
    tiles = torch.ones((1, 2, 2), dtype=torch.int32)
    order, lists, counts = (x[0] for x in topt._frozen_bins(
        state, mask, torch.from_numpy(arrays["w2c"][:1].copy()),
        torch.from_numpy(arrays["K"][:1].copy()), tiles, tst))
    cam = {k: torch.from_numpy(arrays[k][0].copy()) for k in ("w2c", "K", "campos")}

    gauss = render_inputs(state, mask)
    leaves = {k: v.clone().requires_grad_(v.is_floating_point())
              for k, v in gauss.items()}
    out = tapi.render_fixed_binning(leaves, order, lists, counts, cam, tst)
    color = torch.from_numpy(arrays["color"][0].copy())
    loss = (out["render"] - color).abs().mean() + out["depth"].mean()
    grads = torch.autograd.grad(loss, [leaves[k] for k in ("xyz", "opacity", "shs")])

    jgauss = jrender_inputs(jstate, (jalive if pool == "alive" else jstable)(jstate))
    args = tuple(jnp.asarray(x.numpy()) for x in (order, lists, counts))
    jcam = tuple(jnp.asarray(arrays[k][0]) for k in ("w2c", "K", "campos"))
    want = jfixed(jgauss, *args, *jcam, jst)

    def jloss(floats):
        o = jfixed.__wrapped__(dict(jgauss, **floats), *args, *jcam, jst)
        return (jnp.abs(o["render"] - jnp.asarray(arrays["color"][0])).mean()
                + o["depth"].mean())

    jgrads = jax.grad(jloss)({k: jgauss[k] for k in ("xyz", "opacity", "shs")})
    for k in ("render", "depth", "T_map", "normal", "color_hit_weight",
              "depth_hit_weight"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
    for k in ("color_index_map", "depth_index_map"):
        assert np.array_equal(out[k].numpy(), np.asarray(want[k])), k
    assert (out["depth_index_map"] >= 0).any()
    for k, g in zip(("xyz", "opacity", "shs"), grads):
        w = np.asarray(jgrads[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max() + 1e-12, err_msg=k)
        assert np.abs(w).max() > 0


@pytest.mark.parametrize("mode,ratio", [("local", -1.0), ("global", 0.4)])
def test_optimize_chain_freeze_binning_matches(problem, mode, ratio):
    """``optimize_chain(freeze_binning=True)`` (:641-665): sorted and binned
    once per frame, then 5 iterations through ``render_fixed_binning``;
    parameters within 1e-5 of JAX's, confidences equal."""
    jstate, arrays, jst, tst = problem
    n_iters, seq = 5, np.array([0, 1, 1, 0, 1])
    want_state, want_report = jopt.optimize_chain(
        jstate, *_jframes(arrays), jnp.asarray(seq), n_iters,
        {k: jnp.float32(v) for k, v in LRS.items()}, _jweights(_weights()), jst,
        mode=mode, sample_ratio=ratio, mask_depth_positive=True,
        max_weight=0.5, freeze_binning=True)
    state = _port_state(jstate)
    report = topt.optimize_chain(state, *_tframes(arrays), seq, n_iters, LRS,
                                 _weights(), tst, mode, ratio, True, 0.5,
                                 freeze_binning=True)
    _compare_reports(report, want_report)
    _compare_states(state, want_state)
    assert (state.confidence.numpy() > np.asarray(jstate.confidence)).any()
