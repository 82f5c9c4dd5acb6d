"""Port parity: the rasterizer (projection, shade, binning, plain blend and
the render API) against ``rtgslam_tpu`` on the ``test_rasterizer`` scenes.

Tolerances: binning (order, tile lists, counts, overflow) and index maps
must be EXACTLY equal.  Float outputs hold to 1e-5 absolute: projection
and shade run the same float32 operations, and the blend's color and
transmittance differ only by the summation order of the per-chunk matmuls.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_rasterizer import make_scene  # noqa: E402

from rtgslam_tpu.ops.rasterize import api as japi  # noqa: E402
from rtgslam_tpu.ops.rasterize import binning as jbin  # noqa: E402
from rtgslam_tpu.ops.rasterize import blend as jblend  # noqa: E402
from rtgslam_tpu.ops.rasterize import project as jproj  # noqa: E402
from rtgslam_torch.ops.rasterize import api as tapi  # noqa: E402
from rtgslam_torch.ops.rasterize import binning as tbin  # noqa: E402
from rtgslam_torch.ops.rasterize import blend as tblend  # noqa: E402
from rtgslam_torch.ops.rasterize import project as tproj  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
SCENES = [(0, 8), (1, 24), (3, 40)]          # (seed, alive gaussians)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_scene(g, cam, st):
    tg = {k: _t(v) for k, v in g.items()}
    tc = {k: _t(np.asarray(v, np.float32)) for k, v in cam.items()}
    fields = {f.name: getattr(st, f.name)
              for f in dataclasses.fields(tapi.RasterSettings)}
    return tg, tc, tapi.RasterSettings(**fields)


def _assert_tree(got, want, exact=()):
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        if k in exact or w.dtype.kind in "iub":
            assert np.array_equal(g, w), k
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("seed,n_alive", SCENES)
def test_projection_and_shade(seed, n_alive):
    g, cam, st = make_scene(P=64, n_alive=n_alive, seed=seed)
    tg, tc, _ = _port_scene(g, cam, st)
    args = ("xyz", "scales", "rotations", "alive")
    a = jproj.project_geometry(*(g[k] for k in args), cam["w2c"], cam["K"],
                               st.width, st.height)
    b = tproj.project_geometry(*(tg[k] for k in args), tc["w2c"], tc["K"],
                               st.width, st.height)
    _assert_tree(b._asdict(), a._asdict(), exact=("visible", "radius"))
    shs = g["shs"].reshape(64, -1)
    a = jproj.shade_cols(g["xyz"], shs, g["normal"], cam["campos"], 3,
                         st.normal_threshold)
    b = tproj.shade_cols(tg["xyz"], _t(shs), tg["normal"], tc["campos"], 3,
                         st.normal_threshold)
    for x, y in zip(b, a):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=ATOL)


@pytest.mark.parametrize("seed,n_alive", SCENES)
def test_project_and_shade_compat_surface(seed, n_alive):
    """``project`` (a ``FullProjection`` over the whole array) and ``shade``
    against the JAX package's, at ATOL; visible and radius exact."""
    g, cam, st = make_scene(P=64, n_alive=n_alive, seed=seed)
    tg, tc, _ = _port_scene(g, cam, st)
    args = ("xyz", "scales", "rotations", "opacity", "shs", "normal", "alive")
    tail = (st.width, st.height, st.sh_degree, st.normal_threshold)
    a = jproj.project(*(g[k] for k in args), cam["w2c"], cam["K"],
                      cam["campos"], *tail)
    b = tproj.project(*(tg[k] for k in args), tc["w2c"], tc["K"],
                      tc["campos"], *tail)
    assert type(b).__name__ == "FullProjection"
    assert b._fields == a._fields
    _assert_tree(b._asdict(), a._asdict(), exact=("visible", "radius"))
    a = jproj.shade(g["xyz"], g["shs"], g["normal"], cam["campos"], 3,
                    st.normal_threshold)
    b = tproj.shade(tg["xyz"], tg["shs"], tg["normal"], tc["campos"], 3,
                    st.normal_threshold)
    assert b[0].shape == a[0].shape == (64, 3)
    np.testing.assert_allclose(b[0].numpy(), np.asarray(a[0]), atol=ATOL)
    assert np.array_equal(b[1].numpy(), np.asarray(a[1]))


@pytest.mark.parametrize("seed,n_alive,tile_capacity", [
    (0, 8, 64), (1, 24, 64), (3, 40, 64), (3, 40, 128), (5, 60, 32)])
def test_binning_exact(seed, n_alive, tile_capacity):
    """Same projected geometry in, identical depth order, tile lists,
    counts and overflow out (including the capacity-overflow drop)."""
    g, cam, st = make_scene(P=64, n_alive=n_alive, seed=seed)
    geo = jproj.project_geometry(g["xyz"], g["scales"], g["rotations"],
                                 g["alive"], cam["w2c"], cam["K"], st.width,
                                 st.height)
    a = jbin.bin_gaussians(geo, st.height, st.width, 256, tile_capacity, 48)
    b = tbin.bin_gaussians(tproj.Projected(*(_t(x) for x in geo)), st.height,
                           st.width, 256, tile_capacity, 48)
    for f in ("tile_lists", "tile_counts", "order", "n_visible", "overflow"):
        assert np.array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f))), f
    assert np.array_equal(tbin.tile_origins(st.height, st.width).numpy(),
                          np.asarray(jbin.tile_origins(st.height, st.width)))


@pytest.mark.parametrize("capacity", [5, 64, 300])
def test_compact_rows_exact(capacity):
    hit = np.random.default_rng(capacity).random((3, 7, 200)) < 0.3
    a = jbin._compact_rows(jnp.asarray(hit), capacity, 999)
    b = tbin.compact_rows(torch.from_numpy(hit), capacity, 999)
    for x, y in zip(b, a):
        assert np.array_equal(x.numpy(), np.asarray(y))


def _blend_inputs(seed, n_alive, H=64, W=96, Kt=128):
    """Depth-sorted features of a scene, the way api.render builds them."""
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
    return feat, bins, jbin.tile_origins(H, W), st


def _plain_blend(feat, bins, origins, st):
    return tblend.blend_tiles_reference(
        _t(feat.pack()), _t(bins.order), _t(bins.tile_lists),
        _t(bins.tile_counts), _t(origins), st.opaque_threshold, st.T_threshold)


@pytest.mark.parametrize("seed,n_alive", SCENES)
def test_plain_blend_matches_xla_blend(seed, n_alive):
    feat, bins, origins, st = _blend_inputs(seed, n_alive)
    want = jblend.blend_tiles(feat, bins.order, bins.tile_lists,
                              bins.tile_counts, origins, st.opaque_threshold,
                              st.T_threshold)
    got = _plain_blend(feat, bins, origins, st)
    _assert_tree(got._asdict(), want._asdict())


@pytest.mark.parametrize("seed,n_alive", [(0, 24), (3, 40)])
def test_plain_blend_matches_pallas_interpret(seed, n_alive):
    """The TPU kernel K1 replaces, run in Pallas interpret mode."""
    from rtgslam_tpu.ops.rasterize.pallas_blend import blend_tiles_pallas

    feat, bins, origins, st = _blend_inputs(seed, n_alive)
    order_pad = jnp.concatenate([bins.order, jnp.array([-1], jnp.int32)])
    want = blend_tiles_pallas(feat.gather(bins.tile_lists).pack(),
                              order_pad[bins.tile_lists], bins.tile_counts,
                              origins, opaque_threshold=st.opaque_threshold,
                              t_threshold=st.T_threshold, interpret=True)
    got = _plain_blend(feat, bins, origins, st)
    _assert_tree(got._asdict(), want._asdict())


def test_blend_wrapper_takes_plain_path_on_cpu():
    feat, bins, origins, st = _blend_inputs(1, 24)
    args = (_t(feat.pack()), _t(bins.order), _t(bins.tile_lists),
            _t(bins.tile_counts), _t(origins), st.opaque_threshold)
    before = dict(tblend.launches)
    got = tblend.blend_tiles(*args)
    want = tblend.blend_tiles_reference(*args)
    assert tblend.launches == before   # no kernel launch on CPU
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    with pytest.raises(TypeError):
        tblend.blend_tiles(args[0].double(), *args[1:])


@pytest.mark.parametrize("seed,n_alive", SCENES)
def test_render_matches(seed, n_alive):
    g, cam, st = make_scene(P=64, n_alive=n_alive, seed=seed)
    st = dataclasses.replace(st, tile_capacity=1024)
    want = japi.render(g, cam, st)
    tg, tc, ts = _port_scene(g, cam, st)
    _assert_tree(tapi.render(tg, tc, ts), want)


def test_render_from_camera_matches():
    """``render_from_camera`` from a ``MiniCam`` and from a synthetic
    ``Camera``, with settings from a config, against the JAX package's."""
    from rtgslam_tpu.config import read_config
    from rtgslam_tpu.data import MiniCam as JMiniCam
    from rtgslam_tpu.data.synthetic import make_cameras as jmake
    from rtgslam_torch.data import MiniCam
    from rtgslam_torch.data.synthetic import make_cameras as tmake

    g, _, _ = make_scene(P=64, n_alive=40, seed=3)
    tg = {k: _t(v) for k, v in g.items()}
    args = read_config(os.path.join(REPO, "configs", "base.yaml"))
    args.tile_capacity, args.block_capacity = 1024, 256
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.1, -0.05, 0.2]
    kw = dict(width=96, height=64, FoVy=0.8, FoVx=1.1, znear=0.01, zfar=100.0,
              w2c_matrix=w2c)
    cams = [(JMiniCam(**kw), MiniCam(**kw)),
            (jmake(1, 64, 96)[0], tmake(1, 64, 96)[0])]
    for jc, tc in cams:
        want = japi.render_from_camera(g, jc, args=args)
        _assert_tree(tapi.render_from_camera(tg, tc, args=args), want)
    st = tapi.RasterSettings.from_args(args, 64, 96)
    _assert_tree(tapi.render_from_camera(tg, cams[0][1], settings=st),
                 japi.render_from_camera(g, cams[0][0], args=args))


@pytest.mark.parametrize("max_visible", [131072, 96])
def test_render_overflow_matches(max_visible):
    """tile_capacity 64 under 100 gaussians clustered on one screen region
    (as test_rasterizer's overflow test): the farthest entries are dropped
    and counted identically, also when max_visible truncates."""
    g, cam, st = make_scene(P=128, n_alive=100, H=32, W=32)
    xyz = np.asarray(g["xyz"]).copy()
    xyz[:100] = [0.0, 0.0, 2.0] + 0.01 * np.random.default_rng(0).standard_normal((100, 3))
    g = dict(g, xyz=jnp.asarray(xyz))
    st = dataclasses.replace(st, tile_capacity=64, block_capacity=256,
                             max_visible=max_visible)
    want = japi.render(g, cam, st)
    assert int(want["overflow"]) > 0
    tg, tc, ts = _port_scene(g, cam, st)
    _assert_tree(tapi.render(tg, tc, ts), want)


@pytest.mark.parametrize("seed,n_alive,frac", [(1, 24, 0.5), (3, 40, 0.3), (3, 40, 0.0)])
def test_render_model_and_stable_matches(seed, n_alive, frac):
    g, cam, st = make_scene(P=64, n_alive=n_alive, seed=seed)
    st = dataclasses.replace(st, tile_capacity=1024)
    stable = np.asarray(g["alive"]) & (
        np.random.default_rng(seed).random(64) < frac)
    want_out, want_cidx, _ = japi.render_model_and_stable(
        g, jnp.asarray(stable), cam["w2c"], cam["K"], cam["campos"], st)
    tg, tc, ts = _port_scene(g, cam, st)
    got_out, got_cidx = tapi.render_model_and_stable(tg, _t(stable), tc, ts)
    _assert_tree(got_out, want_out)
    assert np.array_equal(got_cidx.numpy(), np.asarray(want_cidx))
