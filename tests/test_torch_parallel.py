"""Port parity: the multi-device path (``rtgslam_torch/parallel/``) on meshes
of virtual CPU shards, against the port's one-device functions and the JAX
package's ``parallel/``.

Inputs: ``parallel/sharded.py::_tiny_problem`` (256 slots, 64 alive,
32x32), which both packages build from the same numpy draws, made into
``tests/torch_parity.py::parallel_case`` (rows 0-31 stable, 32-63
unstable, random confidences, flat discs, and per frame its own colour,
depth and camera).

Tolerances, each with its reason:
  * the mesh's collectives: a pairwise tree in shard order, so a sum of
    distinct values equals that tree exactly, and the mean of identical
    values on 2, 4 or 8 shards is the value bit for bit;
  * ``sp_render`` against ``render``: bitwise (the blend is per tile);
    against the JAX ``render``, ``test_torch_rasterize``'s 1e-5 with the
    index maps exact;
  * the same frame on every shard against the one-device
    ``optimize_chain``: bitwise (the tree mean of four equal gradients is
    that gradient); against the JAX ``optimize_chain``,
    ``test_torch_optimize``'s parameters 1e-5 absolute, confidences exact;
  * distinct frames against the JAX-on-CPU fixture
    ``tests/data/parallel_tiny_jax_cpu.json`` (``torch_parity.py
    --parallel``): ``test_torch_optimize``'s parameters 1e-5 absolute,
    totals rtol 1e-5, confidences exact;
  * the tile-sharded blend of ``sp_optimize_execute`` against the
    partials-and-reduce backward the card runs on one device: bitwise;
  * ``sp_optimize_execute`` against the port's ``optimize_execute``:
    ``tests/test_parallel.py``'s report rtol 1e-4 / atol 1e-6, parameters
    rtol 2e-4 / atol 2e-6, confidences exact (on the CPU the one-device
    backward is the plain twin, which adds chunk by chunk);
  * the mapper with ``mesh=`` four CPU shards against the JAX mapper with
    ``multi_device`` on a 4-device CPU mesh
    (``tests/data/parallel_mapper_64x64_jax_cpu.json``, ``torch_parity.py
    --parallel --mapper``; 64x64 keeps the port's run under 15 s on one
    thread): ``test_torch_entry``'s poses 1e-3, ATE 0.05 cm, PSNR 0.2 dB.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch_parity as tp  # noqa: E402
from test_rasterizer import make_scene  # noqa: E402

from rtgslam_tpu.models import optimize as jopt  # noqa: E402
from rtgslam_tpu.ops.rasterize import api as japi  # noqa: E402
from rtgslam_tpu.parallel import sharded as jsharded  # noqa: E402
from rtgslam_torch.models import optimize as topt  # noqa: E402
from rtgslam_torch.models.gaussian_map import MapState  # noqa: E402
from rtgslam_torch.ops.rasterize import api as tapi  # noqa: E402
from rtgslam_torch.parallel import (dp_global_optimize,  # noqa: E402
                                    dp_local_optimize, dp_optimize_step,
                                    dryrun_multichip, make_mesh, sp_render)
from rtgslam_torch.parallel import sharded as tsharded  # noqa: E402
from rtgslam_torch.parallel.sp_optimize import sp_optimize_execute  # noqa: E402

torch.set_num_threads(1)
N = tp.PARALLEL_SHARDS
LRS = {k: tp.PARALLEL_LR for k in topt.PARAM_KEYS}
WEIGHTS = tp.PARALLEL_WEIGHTS
WINDOW = ("color", "depth", "normal", "w2c", "K", "campos")


def cpu_mesh(n=N):
    return make_mesh(devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_make_mesh(monkeypatch):
    mesh = make_mesh(devices=["cpu"] * 4, axis="sp")
    assert mesh.size == 4 and mesh.axis == "sp"
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError):
        make_mesh(5, devices=["cpu"] * 4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert make_mesh().devices == tuple(torch.device(f"cuda:{i}")
                                        for i in range(3))
    assert make_mesh(2).devices == (torch.device("cuda:0"),
                                    torch.device("cuda:1"))


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_mesh_sum_is_a_shard_order_tree(n):
    """Distinct values are added as (s0 + s1) + (s2 + s3) ..., an odd one
    carried to the next level; psum and pmean hand every shard the result,
    dicts key by key."""
    rng = np.random.default_rng(n)
    vals = [torch.from_numpy(rng.standard_normal(257).astype(np.float32)
                             * 10.0 ** rng.integers(-6, 7)) for _ in range(n)]
    level = list(vals)
    while len(level) > 1:
        nxt = [level[i] + level[i + 1] for i in range(0, len(level) - 1, 2)]
        level = nxt + level[len(nxt) * 2:]
    mesh = cpu_mesh(n)
    assert torch.equal(mesh.sum(vals), level[0])
    for got in mesh.psum(vals):
        assert torch.equal(got, level[0])
    for got in mesh.pmean(vals):
        assert torch.equal(got, level[0] / n)
    both = mesh.sum([{"a": v, "b": 2 * v} for v in vals])
    assert torch.equal(both["a"], level[0]) and set(both) == {"a", "b"}
    assert mesh.broadcast(0.8) == [0.8] * n


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_mean_of_equal_values_is_exact(n):
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 3)).astype(np.float32)) * 1e-3
    g[0, 0] = 1e-40          # a subnormal survives too
    assert torch.equal(cpu_mesh(n).mean([g] * n), g)


# ---------------------------------------------------------------------------
# sp_render
# ---------------------------------------------------------------------------

def _scene():
    """test_rasterizer's scene at 80x112: 5 x 7 = 35 tiles, which no mesh
    of 2, 4 or 8 shards divides."""
    g, cam, st = make_scene(P=128, n_alive=40, seed=3, H=80, W=112)
    st = dataclasses.replace(st, tile_capacity=128)
    tg = {k: torch.from_numpy(np.array(v)) for k, v in g.items()}
    tc = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in cam.items()}
    ts = tapi.RasterSettings(**{f.name: getattr(st, f.name)
                                for f in dataclasses.fields(tapi.RasterSettings)})
    return (g, cam, st), (tg, tc, ts)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_sp_render_equals_render_bitwise(n):
    _, (tg, tc, ts) = _scene()
    want = tapi.render(tg, tc, ts)
    got = sp_render(tg, tc, ts, cpu_mesh(n))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (got["depth_index_map"] >= 0).any()


def test_sp_render_matches_jax_render():
    (g, cam, st), (tg, tc, ts) = _scene()
    want = japi.render(g, cam, st)
    got = sp_render(tg, tc, ts, cpu_mesh())
    for k, w in want.items():
        g_, w = np.asarray(got[k]), np.asarray(w)
        if w.dtype.kind in "iub":
            assert np.array_equal(g_, w), k
        else:
            np.testing.assert_allclose(g_, w, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# frame-parallel optimization
# ---------------------------------------------------------------------------

def test_tiny_problem_matches_jax():
    """Both packages' ``_tiny_problem`` hold the same arrays, bit for bit,
    and the same raster settings."""
    jstate, jframes, jst = jsharded._tiny_problem(4)
    state, frames, st = tsharded._tiny_problem(4)
    for f in dataclasses.fields(MapState):
        assert np.array_equal(getattr(state, f.name).numpy(),
                              np.asarray(getattr(jstate, f.name))), f.name
    for k, v in frames.items():
        assert np.array_equal(v.numpy(), np.asarray(getattr(jframes, k))), k
    for f in dataclasses.fields(tapi.RasterSettings):
        assert getattr(st, f.name) == getattr(jst, f.name), f.name


def _case(H=32, W=32):
    st, fr = tp.parallel_case(H, W)
    _, _, settings = tsharded._tiny_problem(N, H, W)
    return st, fr, settings


def _state(st):
    return MapState.from_numpy(st)


def _window(fr, same_frame=False):
    if same_frame:
        fr = {k: np.broadcast_to(v[:1], v.shape).copy() for k, v in fr.items()}
    return tuple(torch.from_numpy(fr[k].copy()) for k in WINDOW)


def _jstate(st):
    jstate, _, _ = jsharded._tiny_problem(N)
    return jstate.replace(**{f.name: jnp.asarray(st[f.name])
                             for f in dataclasses.fields(jstate)})


@pytest.mark.parametrize("mode,ratio,depth_mask", [
    ("local", -1.0, False), ("global", -1.0, False), ("global", -1.0, True),
    ("global", 0.4, False)])
def test_dp_same_frame_equals_chain_bitwise(mode, ratio, depth_mask):
    """The same frame on all four shards against the one-device
    ``optimize_chain`` on that frame: parameters bit for bit.  The local
    pass's confidence too; the global pass leaves the confidence as it was,
    as the JAX ``dp_global_optimize`` does (the chain bumps it)."""
    st, fr, settings = _case()
    if depth_mask:
        fr["depth"][:, :, :10] = 0.0
    window = _window(fr, same_frame=True)
    steps = tp.PARALLEL_STEPS
    dp, chain = _state(st), _state(st)
    if mode == "local":
        dp_local_optimize(dp, *window, steps, LRS, WEIGHTS, settings, cpu_mesh(),
                          depth_mask, 0.5)
    else:
        dp_global_optimize(dp, *window, steps, LRS, WEIGHTS, settings,
                           cpu_mesh(), ratio, depth_mask)
    topt.optimize_chain(chain, *(x[:1] for x in window), np.zeros(steps, np.int64),
                        steps, LRS, WEIGHTS, settings, mode, ratio, depth_mask,
                        0.5 if mode == "local" else 0.0)
    for k in topt.PARAM_KEYS:
        assert torch.equal(getattr(dp, k), getattr(chain, k)), k
    if mode == "local":
        assert torch.equal(dp.confidence, chain.confidence)
    else:
        assert torch.equal(dp.confidence, torch.from_numpy(st["confidence"]))
    moved = (dp.features_dc != torch.from_numpy(st["features_dc"])).any(-1)
    assert moved[32:64].any() if mode == "local" else moved[:32].any()


def test_dp_depth_mask_changes_the_result():
    """``mask_depth_positive`` restricts the loss to valid depth: with a
    stripe of invalid depth the masked pass moves the map elsewhere than
    the unmasked one (tests/test_parallel.py:155-199)."""
    st, fr, settings = _case()
    fr["depth"][:, :, :10] = 0.0
    window = _window(fr, same_frame=True)
    a, b = _state(st), _state(st)
    for s, flag in ((a, True), (b, False)):
        dp_global_optimize(s, *window, 2, LRS, WEIGHTS, settings, cpu_mesh(),
                           -1.0, flag)
    assert not torch.equal(a.features_dc, b.features_dc)


@pytest.mark.parametrize("mode", ["local", "global"])
def test_dp_same_frame_matches_jax_chain(mode):
    """The same: the JAX ``optimize_chain`` live, to 1e-5."""
    st, fr, settings = _case()
    window = _window(fr, same_frame=True)
    steps = tp.PARALLEL_STEPS
    jwin = tuple(jnp.asarray(x[:1].numpy()) for x in window)
    jstate, _ = jopt.optimize_chain(
        _jstate(st), *jwin, jnp.zeros(steps, jnp.int32), steps,
        {k: jnp.float32(v) for k, v in LRS.items()},
        {k: jnp.float32(v) for k, v in WEIGHTS.items()},
        jsharded._tiny_problem(N)[2], mode=mode, sample_ratio=-1.0,
        mask_depth_positive=False, max_weight=0.5 if mode == "local" else 0.0)
    dp = _state(st)
    if mode == "local":
        dp_local_optimize(dp, *window, steps, LRS, WEIGHTS, settings, cpu_mesh(),
                          False, 0.5)
    else:
        dp_global_optimize(dp, *window, steps, LRS, WEIGHTS, settings,
                           cpu_mesh(), -1.0)
    for k in topt.PARAM_KEYS:
        np.testing.assert_allclose(getattr(dp, k).numpy(),
                                   np.asarray(getattr(jstate, k)), atol=1e-5,
                                   err_msg=k)
    if mode == "local":
        assert np.array_equal(dp.confidence.numpy(), np.asarray(jstate.confidence))


@pytest.fixture(scope="module")
def jax_parallel():
    with open(tp.PARALLEL_JSON) as f:
        return json.load(f)


def _compare_rows(state, want, label):
    """The fixture's rows to 1e-5, confidences exactly; prints the largest
    gap (``pytest -s``)."""
    gaps = {}
    for k in tp.PARALLEL_FIELDS:
        got = getattr(state, k).numpy()[:tp.PARALLEL_ROWS]
        w = np.asarray(want[k], np.float32)
        gaps[k] = float(np.abs(got - w).max())
        if k == "confidence":
            assert np.array_equal(got, w), k
        else:
            np.testing.assert_allclose(got, w, atol=1e-5, err_msg=k)
    print(f"[{label}] largest gap to JAX: {gaps}")


def test_dp_optimize_step_matches_jax_fixture(jax_parallel):
    st, fr, settings = _case()
    state = _state(st)
    frames = {k: torch.from_numpy(v.copy()) for k, v in fr.items()}
    hyper = dict(WEIGHTS, hist_opacity=state.opacity.clone(),
                 hist_scaling=state.scaling.clone(), hist_xyz=state.xyz.clone(),
                 hist_rotation_raw=state.rotation.clone())
    unstable = state.status == 1
    total = dp_optimize_step(state, frames, state.status > 0, unstable, LRS,
                             hyper, settings, cpu_mesh(), tp.PARALLEL_STEPS)
    want = jax_parallel["dp_optimize_step"]
    np.testing.assert_allclose(float(total), want["total"], rtol=1e-5)
    _compare_rows(state, want["rows"], "dp_optimize_step")
    moved = (state.xyz != torch.from_numpy(st["xyz"])).any(-1)
    assert moved[32:64].any() and not moved[:32].any()


@pytest.mark.parametrize("name", ["dp_local_optimize", "dp_global_optimize"])
def test_dp_window_matches_jax_fixture(jax_parallel, name):
    st, fr, settings = _case()
    state = _state(st)
    if name == "dp_local_optimize":
        total = dp_local_optimize(state, *_window(fr), tp.PARALLEL_STEPS, LRS,
                                  WEIGHTS, settings, cpu_mesh(), False, 0.5)
    else:
        total = dp_global_optimize(state, *_window(fr), tp.PARALLEL_STEPS, LRS,
                                   WEIGHTS, settings, cpu_mesh(), 0.4)
    want = jax_parallel[name]
    np.testing.assert_allclose(float(total), want["total"], rtol=1e-5)
    _compare_rows(state, want["rows"], name)


def _prepared(st, fr, settings):
    state = _state(st)
    prep = topt.optimize_prepare(state, *_window(fr), settings, "local", -1.0,
                                 False)
    return state, prep, (
        prep.rmasks, prep.lists_orig, prep.counts,
        prep.pool_order[:prep.n_pool], prep.n_pool,
        prep.tile_order[:, :prep.n_live_tiles])


def test_sp_optimize_matches_jax_fixture(jax_parallel):
    st, fr, settings = _case()
    state, prep, p = _prepared(st, fr, settings)
    want = jax_parallel["sp_optimize_execute"]
    assert prep.n_live_tiles == want["n_live_tiles"]
    report = sp_optimize_execute(
        state, *_window(fr), *p, tp.PARALLEL_SEQ, len(tp.PARALLEL_SEQ), LRS,
        WEIGHTS, settings, "local", 0.5,
        topt.list_crop(prep.cnt_max, prep.lists_orig.shape[-1]), cpu_mesh())
    for k in topt.REPORT_KEYS:
        np.testing.assert_allclose(float(report[k]), want["report"][k],
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    _compare_rows(state, want["rows"], "sp_optimize_execute")


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_blend_equals_partials_and_reduce(n):
    """The tile-sharded blend (K1 residual per shard forward; K2 per shard,
    then one reduce over all the partials backward) against the one-device
    blend of the same lists as the card computes it (``blend.blend_bwd`` on
    CUDA: the partials of every position, then the reduce): the seven
    outputs and the feature-row gradient bit for bit, on 37 tiles that no
    mesh here divides."""
    import chip_smoke
    from rtgslam_torch.ops.rasterize import blend
    from rtgslam_torch.parallel.sp_optimize import sharded_blend

    feat, order, lists, counts, origins = chip_smoke.random_tiles(
        "cpu", T=37, Kt=256, V=3000)
    feat.requires_grad_(True)
    fn = sharded_blend(cpu_mesh(n), lists, counts, origins, feat.shape[0] - 1)
    got = fn(feat, order, lists, counts, origins, 0.6, 1e-4)
    want, entry, done, cc = blend.blend_tiles(feat.detach(), order, lists,
                                              counts, origins, 0.6, 1e-4,
                                              residuals=True)
    for k in blend.TileOutputs._fields:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    gc, gd, gt = chip_smoke.random_cotangents(lists.shape[0], "cpu")
    (g,) = torch.autograd.grad([got.color, got.depth, got.T_final], [feat],
                               [gc, gd, gt])
    partials = blend.blend_bwd_partials(
        feat.detach(), order, lists, counts, origins, entry, done, cc, gc, gd,
        want.T_final * gt, want.depth_index, 0.6)
    index = blend.row_index(lists, counts, feat.shape[0] - 1)
    assert torch.equal(g, blend.blend_bwd_reduce(partials, index, done))
    assert g.abs().max() > 0


@pytest.mark.parametrize("n", [4, 8])
def test_sp_optimize_matches_optimize_execute(n):
    """The tile-sharded loop against the one-device compact loop on the same
    prepare outputs at 64x64; the compact tiles (the live-first 7 of each
    frame's 4 x 4, of which 9 are live) divide over neither mesh."""
    st, fr, settings = _case(64, 64)
    state, prep, p = _prepared(st, fr, settings)
    tiles = p[5][:, :7]
    assert tiles.shape[1] == 7 and prep.n_live_tiles >= 7
    ref = _state(st)
    args = (*_window(fr), *p[:5], tiles, tp.PARALLEL_SEQ, len(tp.PARALLEL_SEQ),
            LRS, WEIGHTS, settings, "local", 0.5,
            topt.list_crop(prep.cnt_max, prep.lists_orig.shape[-1]))
    want = topt.optimize_execute(ref, *args)
    got = sp_optimize_execute(state, *args, cpu_mesh(n))
    for k in topt.REPORT_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    print(f"[sp_optimize_execute, {n} shards] largest gap to optimize_execute: "
          + str({k: float((getattr(state, k) - getattr(ref, k)).abs().max())
                 for k in ("xyz", "opacity", "scaling", "features_dc")}))
    for k in ("xyz", "opacity", "scaling", "features_dc"):
        np.testing.assert_allclose(getattr(state, k).numpy(),
                                   getattr(ref, k).numpy(), rtol=2e-4,
                                   atol=2e-6, err_msg=k)
    assert torch.equal(state.confidence, ref.confidence)
    assert not torch.equal(state.xyz, torch.from_numpy(st["xyz"]))


def test_dryrun_multichip(capsys):
    dryrun_multichip(N, device="cpu")
    assert "OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the mapper's multi_device branches
# ---------------------------------------------------------------------------

def test_conftest_args_are_base_args(base_args):
    assert vars(tp.conftest_args()) == vars(base_args)


def test_mapper_mesh_entries():
    """One entry per shard, cycled as the JAX mapper cycles them."""
    from rtgslam_torch.slam.mapper import Mapper

    m = Mapper.__new__(Mapper)
    m.mesh = cpu_mesh()
    assert m._mesh_entries(["a"], 1) == ["a"] * 4
    assert m._mesh_entries(["a", "b", "b"], 2) == ["a", "b", "b", "b"]
    assert m._mesh_entries(["c", "b", "a"], 3) == ["c", "b", "a", "c"]
    assert m._mesh_entries(list("abcde"), 5) == list("abcd")


def test_mapper_on_mesh_matches_jax(base_args, monkeypatch):
    """The slice loop with ``mesh=`` four CPU shards against the JAX loop
    with ``multi_device`` on a 4-device CPU mesh: local passes on frames 0
    and 1, a windowed global pass on frame 3, the standalone render (the
    last keyframe's eval; the frames' model maps reuse the lifecycle's
    render, as in JAX) tile-sharded."""
    from rtgslam_tpu.data.synthetic import make_cameras
    from rtgslam_torch.slam import mapper as mapper_mod
    from rtgslam_torch.slam.run import run_sequence

    with open(tp.PARALLEL_MAPPER_JSON.format(H=64, W=64)) as f:
        ref = json.load(f)
    H, W, n = ref["height"], ref["width"], ref["frames"]
    calls = []
    for name in ("dp_local_optimize", "dp_global_optimize", "sp_render"):
        fn = getattr(mapper_mod, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mapper_mod, name, counted)
    args = tp.parallel_mapper_args(base_args, H, W)
    cams = make_cameras(n_frames=n, H=H, W=W)
    res = run_sequence(args, tp.port_cameras(cams), "cpu",
                       tp.replay(tp.jax_priorities(n, H, W)), cpu_mesh())
    assert calls.count("dp_local_optimize") == 2
    assert calls.count("dp_global_optimize") == 1
    assert calls.count("sp_render") == 1
    assert res["max_overflow"] == ref["max_overflow"] == 0
    print(f"[mapper on the mesh] gaps to JAX: poses "
          f"{np.abs(res['poses'] - np.asarray(ref['poses'])).max():.3g}, ATE "
          f"{abs(res['ate_cm'] - ref['ate_cm']):.3g} cm, PSNR "
          f"{abs(res['eval']['psnr'] - ref['psnr']):.3g} dB")
    np.testing.assert_allclose(res["poses"], np.asarray(ref["poses"]), atol=1e-3)
    assert abs(res["ate_cm"] - ref["ate_cm"]) <= 0.05
    assert abs(res["eval"]["psnr"] - ref["psnr"]) <= 0.2
