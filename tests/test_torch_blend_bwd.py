"""Port parity: the blend's residual and transmission modes, its backward
and the differentiable ``BlendFunction`` (plain twins, on the CPU) against
``rtgslam_tpu``'s ``blend_tiles_fused`` VJP, ``blend_transmission`` and the
TPU backward kernel in Pallas interpret mode.

Inputs: the ``test_rasterizer`` scenes (one 128-entry chunk per tile) and
random multi-chunk tile sets whose dense tiles saturate and exit early,
all made from numpy seeds.

Tolerances:
  * entry T and final T 1e-5 absolute: the same float32 operations, summed
    in another order by the log-space matmuls;
  * ``done`` and the ``T != 1`` mask exactly equal: T is 1 iff every alpha
    is exactly 0 on both sides;
  * gradients rtol 1e-4 with an absolute floor of 1e-5 of the largest
    gradient (measured on the CPU, torch 2.13 and jax 0.9: at most 2.9e-6
    of the largest): per-pixel terms are summed over 256 pixels and many
    tiles in another order than XLA's, and the JAX backward reduces through
    a moment-basis matmul;
  * the float64 gradient check at torch's defaults.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_rasterizer import make_scene  # noqa: E402

from rtgslam_tpu.ops.rasterize import binning as jbin  # noqa: E402
from rtgslam_tpu.ops.rasterize import blend as jblend  # noqa: E402
from rtgslam_tpu.ops.rasterize import project as jproj  # noqa: E402
from rtgslam_torch.ops.rasterize import blend as tblend  # noqa: E402

torch.set_num_threads(1)
OPAQUE, T_THR = 0.6, 1e-4
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def scene_tiles(seed, n_alive, Kt=128):
    """Depth-sorted feature rows and tile lists of a test_rasterizer scene,
    the way the render builds them: (rows [V+1, 11], order, lists, counts,
    origins) as numpy."""
    H, W = 64, 96
    g, cam, st = make_scene(P=64, n_alive=n_alive, seed=seed, H=H, W=W)
    pr = jproj.project(g["xyz"], g["scales"], g["rotations"], g["opacity"],
                       g["shs"], g["normal"], g["alive"], cam["w2c"], cam["K"],
                       cam["campos"], W, H, st.sh_degree, st.normal_threshold)
    bins = jbin.bin_gaussians(pr, H, W, 256, Kt, max_visible=64)
    o = bins.order
    feat = jblend._pack_features((
        pr.mean2d[o, 0], pr.mean2d[o, 1], pr.conic[o, 0], pr.conic[o, 1],
        pr.conic[o, 2], pr.depth[o], pr.rgb[o, 0], pr.rgb[o, 1], pr.rgb[o, 2],
        pr.opacity[o], pr.normal_elig[o].astype(jnp.float32)))
    return tuple(np.asarray(x) for x in (
        feat.pack(), bins.order, bins.tile_lists, bins.tile_counts,
        jbin.tile_origins(H, W)))


def random_tiles(seed, T=6, Kt=384, V=1400, opacity=0.99):
    """Random rows over a Tx1 strip of tiles with ascending per-tile lists
    of the rows centred near each tile; lists hold 0..Kt entries, so the
    dense tiles saturate before their last chunk."""
    rng = np.random.default_rng(seed)
    feat = np.zeros((V + 1, 11), np.float32)
    feat[:V, 0] = rng.uniform(0, 16 * T, V)
    feat[:V, 1] = rng.uniform(0, 16, V)
    s = rng.uniform(1.5, 6.0, (V, 2))
    feat[:V, 2], feat[:V, 4] = 1 / s[:, 0] ** 2, 1 / s[:, 1] ** 2
    feat[:V, 3] = rng.uniform(-0.4, 0.4, V) * np.sqrt(feat[:V, 2] * feat[:V, 4])
    feat[:V, 5] = np.sort(rng.uniform(0.5, 5.0, V))
    feat[:V, 6:9] = rng.uniform(0, 1, (V, 3))
    feat[:V, 9] = rng.uniform(0.05, opacity, V)
    feat[:V, 10] = rng.uniform(0, 1, V) > 0.3
    order = rng.permutation(V).astype(np.int32)
    counts = rng.integers(0, Kt + 1, T).astype(np.int32)
    counts[0] = 0
    counts[-1] = Kt
    lists = np.full((T, Kt), V, np.int32)
    for t in range(T):
        near = np.nonzero(np.abs(feat[:V, 0] - 16 * t - 8) < 16)[0]
        counts[t] = min(counts[t], near.size)
        lists[t, :counts[t]] = np.sort(rng.permutation(near)[:counts[t]])
    origins = np.stack([np.arange(T) * 16.0, np.zeros(T)], -1).astype(np.float32)
    return feat, order, lists, counts, origins


CASES = {
    "scene0": lambda: scene_tiles(0, 24),
    "scene3": lambda: scene_tiles(3, 40),
    "random1": lambda: random_tiles(1),
    "random2": lambda: random_tiles(2, Kt=256, opacity=0.5),
}


def _jax_fused_inputs(feat, order, lists):
    cols = jblend.FeatCols.unpack(jnp.asarray(feat))
    gidx = jnp.concatenate([jnp.asarray(order), jnp.array([-1], jnp.int32)])
    return cols, gidx[jnp.asarray(lists)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_residual_forward_matches_fused_vjp_residuals(case):
    feat, order, lists, counts, origins = CASES[case]()
    cols, gidx = _jax_fused_inputs(feat, order, lists)
    want, res = jblend._fused_fwd(cols.gather(jnp.asarray(lists)), gidx,
                                  jnp.asarray(counts), jnp.asarray(origins),
                                  OPAQUE, T_THR)
    got, entry, done, _ = tblend.blend_tiles(
        *(_t(x) for x in (feat, order, lists, counts, origins)), OPAQUE, T_THR,
        residuals=True)
    assert np.array_equal(done.numpy(), np.asarray(res[4]))
    np.testing.assert_allclose(entry.numpy(), np.asarray(res[3]), atol=1e-5)
    for k in ("color", "depth", "T_final", "depth_weight", "color_weight"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=1e-5)
    for k in ("depth_index", "color_index"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    if case == "random1":   # the early exit is exercised
        n_chunks = -(-counts // min(128, lists.shape[1]))
        assert (done.numpy() < n_chunks).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_transmission_matches_xla(case):
    feat, order, lists, counts, origins = CASES[case]()
    cols6 = feat[:, [0, 1, 2, 3, 4, 9]]
    gathered = tuple(jnp.asarray(cols6[:, i])[jnp.asarray(lists)]
                     for i in range(6))
    want = np.asarray(jblend.blend_transmission(
        gathered, jnp.asarray(counts), jnp.asarray(origins), T_THR))
    got = tblend.blend_transmission(_t(cols6), _t(lists), _t(counts),
                                    _t(origins), T_THR).numpy()
    assert np.array_equal(got != 1.0, want != 1.0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _cotangents(seed, T):
    rng = np.random.default_rng(100 + seed)
    return (rng.standard_normal((T, 256, 3)).astype(np.float32),
            rng.standard_normal((T, 256)).astype(np.float32),
            rng.standard_normal((T, 256)).astype(np.float32))


def _assert_grads(got, want):
    floor = GRAD_FLOOR * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=floor)


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_fused_vjp(case):
    """d(color.wc + depth.wd + T.wt)/d rows: ``BlendFunction`` (the plain
    twins on the CPU) against ``jax.vjp`` of ``blend_tiles_fused`` taken
    through the tile gather to the sorted rows."""
    feat, order, lists, counts, origins = CASES[case]()
    T = lists.shape[0]
    wc, wd, wt = _cotangents(int(case[-1]), T)
    cols, gidx = _jax_fused_inputs(feat, order, lists)

    def f(c):
        return jblend.blend_tiles_fused(
            c.gather(jnp.asarray(lists)), gidx, jnp.asarray(counts),
            jnp.asarray(origins), OPAQUE, T_THR)

    out, vjp = jax.vjp(f, cols)
    f0 = np.zeros((T, 256), jax.dtypes.float0)
    zero = jnp.zeros((T, 256))
    (g_cols,) = vjp(jblend.TileOutputs(
        color=jnp.asarray(wc), depth=jnp.asarray(wd), depth_index=f0,
        color_index=f0, depth_weight=zero, color_weight=zero,
        T_final=jnp.asarray(wt)))
    want = np.stack([np.asarray(c) for c in g_cols], -1)

    x = _t(feat).requires_grad_(True)
    got = tblend.blend_tiles_fused(
        x, *(_t(a) for a in (order, lists, counts, origins)), OPAQUE, T_THR)
    loss = ((got.color * _t(wc)).sum() + (got.depth * _t(wd)).sum()
            + (got.T_final * _t(wt)).sum())
    (g,) = torch.autograd.grad(loss, x)
    assert not got.depth_index.requires_grad and not got.color_weight.requires_grad
    _assert_grads(g.numpy()[:-1], want[:-1])
    assert np.all(g.numpy()[:, 10] == 0)


def test_backward_matches_pallas_interpret():
    """The TPU kernel K2 replaces, run in Pallas interpret mode on the same
    residuals; its per-tile-entry output index-added into the rows."""
    from rtgslam_tpu.ops.rasterize.pallas_blend import blend_bwd_pallas

    feat, order, lists, counts, origins = random_tiles(1)
    T = lists.shape[0]
    wc, wd, wt = _cotangents(5, T)
    out, entry, done, chunk_color = tblend.blend_tiles(
        *(_t(x) for x in (feat, order, lists, counts, origins)), OPAQUE, T_THR,
        residuals=True)
    tfin_gt = out.T_final.numpy() * wt
    got = tblend.blend_bwd_reference(
        _t(feat), _t(order), _t(lists), _t(counts), _t(origins), entry, done,
        chunk_color, _t(wc), _t(wd), _t(tfin_gt), out.depth_index,
        OPAQUE).numpy()

    cols, gidx = _jax_fused_inputs(feat, order, lists)
    per_entry = np.asarray(blend_bwd_pallas(
        cols.gather(jnp.asarray(lists)).pack(), gidx, jnp.asarray(origins),
        jnp.asarray(entry.numpy()), jnp.asarray(done.numpy()),
        jnp.asarray(wc), jnp.asarray(wd), jnp.asarray(tfin_gt),
        jnp.asarray(out.depth_index.numpy()), OPAQUE, interpret=True))
    want = np.zeros_like(feat)
    np.add.at(want, lists.reshape(-1), per_entry.reshape(-1, 11))
    _assert_grads(got[:-1], want[:-1])


def test_blend_function_gradcheck():
    """torch.autograd.gradcheck of BlendFunction in float64 on two small
    tiles (the counterpart of test_rasterizer's finite-difference check):
    color, depth and T_final against central differences."""
    rng = np.random.default_rng(7)
    V, Kt = 10, 16
    feat = np.zeros((V + 1, 11))
    feat[:V, 0] = rng.uniform(2, 30, V)
    feat[:V, 1] = rng.uniform(2, 14, V)
    s = rng.uniform(3.0, 6.0, (V, 2))
    feat[:V, 2], feat[:V, 4] = 1 / s[:, 0] ** 2, 1 / s[:, 1] ** 2
    feat[:V, 3] = rng.uniform(-0.3, 0.3, V) * np.sqrt(feat[:V, 2] * feat[:V, 4])
    feat[:V, 5] = np.sort(rng.uniform(1, 4, V))
    feat[:V, 6:9] = rng.uniform(0, 1, (V, 3))
    feat[:V, 9] = rng.uniform(0.3, 0.7, V)
    feat[:V, 10] = 1.0
    lists = np.full((2, Kt), V, np.int32)
    lists[0, :V] = np.arange(V)
    lists[1, :6] = np.arange(0, V, 2)[:5].tolist() + [9]
    counts = np.array([V, 6], np.int32)
    order = np.arange(V, dtype=np.int32)
    origins = np.array([[0.0, 0.0], [16.0, 0.0]])
    args = (_t(order), _t(lists), _t(counts), _t(origins), 0.5, 1e-8)

    def fn(x):
        out = tblend.blend_tiles_fused(x, *args)
        return out.color, out.depth, out.T_final

    x = _t(feat).requires_grad_(True)
    assert torch.autograd.gradcheck(fn, (x,))


def test_wrappers_take_plain_path_on_cpu():
    feat, order, lists, counts, origins = (
        _t(x) for x in random_tiles(3, T=3, Kt=128))
    before = dict(tblend.launches)
    out, entry, done, chunk_color = tblend.blend_tiles(
        feat, order, lists, counts, origins, OPAQUE, T_THR, residuals=True)
    tblend.blend_transmission(feat[:, [0, 1, 2, 3, 4, 9]].contiguous(), lists,
                              counts, origins)
    bargs = (feat, order, lists, counts, origins, entry, done, chunk_color,
             out.color, out.depth, out.T_final, out.depth_index, OPAQUE)
    g = tblend.blend_bwd(*bargs)
    partials = tblend.blend_bwd_partials(*bargs)
    index = tblend.row_index(lists, counts, feat.shape[0] - 1)
    tblend.blend_bwd_reduce(partials, index, done)
    assert tblend.launches == before   # no kernel launch on CPU
    assert torch.equal(g, tblend.blend_bwd_reference(*bargs))
    # the kernels' split (per-position partials, then the reduce) gives the
    # same gradient, summed in another order
    _assert_grads(tblend.blend_bwd_reduce_reference(
        partials, index, done).numpy()[:-1], g.numpy()[:-1])
    with pytest.raises(ValueError):
        tblend.blend_bwd(*bargs[:5], entry[:1], *bargs[6:])
    with pytest.raises(TypeError):
        tblend.blend_transmission(feat[:, :6].double(), lists, counts, origins)


def _bwd_args(seed=3, T=3, Kt=256):
    feat, order, lists, counts, origins = (
        _t(x) for x in random_tiles(seed, T=T, Kt=Kt))
    out, entry, done, chunk_color = tblend.blend_tiles(
        feat, order, lists, counts, origins, OPAQUE, T_THR, residuals=True)
    wc, wd, wt = (_t(x) for x in _cotangents(seed, T))
    return (feat, order, lists, counts, origins, entry, done, chunk_color, wc,
            wd, out.T_final * wt, out.depth_index, OPAQUE)


BAD_BWD_ARGS = {
    # argument position: (bad value maker, error)
    "tile_counts shape": (3, lambda x: x[:-1], ValueError),
    "tile_counts dtype": (3, lambda x: x.long(), TypeError),
    "chunk_color shape": (7, lambda x: x[..., :2], ValueError),
    "chunk_color dtype": (7, lambda x: x.double(), TypeError),
    "entry shape": (5, lambda x: x[:, :1], ValueError),
    "done dtype": (6, lambda x: x.long(), TypeError),
}


@pytest.mark.parametrize("case", sorted(BAD_BWD_ARGS))
def test_blend_bwd_rejects_bad_arguments(case):
    """A wrong shape or dtype of the backward's arguments raises, on the CPU
    as it would before a kernel launch."""
    i, bad, err = BAD_BWD_ARGS[case]
    args = list(_bwd_args())
    args[i] = bad(args[i])
    with pytest.raises(err):
        tblend.blend_bwd(*args)


@pytest.mark.parametrize("case", ["row_ptr shape", "pos dtype", "pos shape"])
def test_blend_bwd_rejects_bad_index(case):
    args = _bwd_args()
    feat, lists, counts = args[0], args[2], args[3]
    index = tblend.row_index(lists, counts, feat.shape[0] - 1)
    index = {"row_ptr shape": index._replace(row_ptr=index.row_ptr[:-1]),
             "pos dtype": index._replace(pos=index.pos.long()),
             "pos shape": index._replace(pos=index.pos[1:])}[case]
    with pytest.raises((ValueError, TypeError)):
        tblend.blend_bwd(*args, index)
    if case.startswith("pos"):   # the reduce alone reads V from row_ptr
        with pytest.raises((ValueError, TypeError)):
            tblend.blend_bwd_reduce(torch.zeros(lists.shape + (tblend.NGRAD,)),
                                    index, args[6])


@pytest.mark.parametrize("seed,Kt", [(0, 128), (1, 384), (2, 64)])
def test_row_index_matches_brute_force(seed, Kt):
    """The CSR inverse index against a Python loop: every row's positions
    t*Kt + k (k below the tile's count) in ascending order, the sentinel
    row's and the positions past the count left out, rows of count 0
    empty."""
    feat, _, lists, counts, _ = random_tiles(seed, T=5, Kt=Kt)
    V = feat.shape[0] - 1
    lists = lists.copy()
    lists[1, counts[1]:] = 7          # non-sentinel rows past the count
    lists[2, 0] = V                   # a sentinel inside the count
    index = tblend.row_index(_t(lists), _t(counts), V)
    want = [[] for _ in range(V)]
    for t in range(lists.shape[0]):
        for k in range(int(counts[t])):
            if lists[t, k] < V:
                want[lists[t, k]].append(t * Kt + k)
    row_ptr, pos = index.row_ptr.numpy(), index.pos.numpy()
    assert index.row_ptr.dtype == index.pos.dtype == torch.int32
    assert row_ptr.shape == (V + 2,) and pos.shape == (lists.size,)
    assert row_ptr[0] == 0 and row_ptr[-1] == lists.size
    for r in range(V):
        assert pos[row_ptr[r]:row_ptr[r + 1]].tolist() == want[r], r
    assert any(not w for w in want)   # rows of count 0 are there


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reduce_twin_matches_index_add(dtype):
    """The reduce's plain twin against ``index_add_`` of every live
    position's partials into its row (positions past the count or in
    chunks at or past ``done`` add nothing)."""
    feat, _, lists, counts, _ = random_tiles(4, T=6, Kt=384)
    V = feat.shape[0] - 1
    T, Kt = lists.shape
    rng = np.random.default_rng(4)
    partials = _t(rng.standard_normal((T, Kt, tblend.NGRAD))).to(dtype)
    done = _t(np.array([0, 1, 3, 2, 1, 3], np.int32))
    index = tblend.row_index(_t(lists), _t(counts), V)
    got = tblend.blend_bwd_reduce(partials, index, done)
    k = np.arange(Kt)
    live = (k[None] < counts[:, None]) & (k[None] // 128 < done.numpy()[:, None])
    live &= lists < V
    want = torch.zeros((V + 1, 11), dtype=dtype)
    want[:, :10].index_add_(0, _t(lists[live]).long(), partials[_t(live)])
    assert got.dtype == dtype and got.shape == (V + 1, 11)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)
    assert np.all(got.numpy()[V] == 0) and np.all(got.numpy()[:, 10] == 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_color_sums_to_color(case):
    """The residual twin's per-chunk colour sums, added over the chunks,
    give its colour (float64: the twin adds them in chunk order), and are 0
    for the chunks a tile never reached."""
    feat, order, lists, counts, origins = CASES[case]()
    out, entry, done, chunk_color = tblend.blend_tiles(
        _t(feat).double(), _t(order), _t(lists), _t(counts),
        _t(origins).double(), OPAQUE, T_THR, residuals=True)
    assert chunk_color.shape == entry.shape + (3,)
    np.testing.assert_allclose(chunk_color.sum(dim=1).numpy(),
                               out.color.numpy(), rtol=0, atol=1e-12)
    reached = torch.arange(entry.shape[1])[None] < done[:, None]
    assert torch.all(chunk_color[~reached] == 0)


def test_backward_with_prebuilt_index():
    """``BlendFunction`` with the lists' row index built ahead (the compact
    optimize loop's way) gives the same gradient as building it in the
    backward."""
    feat, order, lists, counts, origins = (_t(x) for x in random_tiles(2))
    wc = _t(_cotangents(2, lists.shape[0])[0])
    index = tblend.row_index(lists, counts, feat.shape[0] - 1)
    grads = []
    for ix in (None, index):
        x = feat.clone().requires_grad_(True)
        out = tblend.blend_tiles_fused(x, order, lists, counts, origins,
                                       OPAQUE, T_THR, ix)
        grads.append(torch.autograd.grad((out.color * wc).sum(), x)[0])
    assert torch.equal(grads[0], grads[1])
    assert grads[0].abs().max() > 0
