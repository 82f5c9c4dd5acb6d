"""Checkpoints across packages: the port's PLY I/O (``rtgslam_torch/utils/
ply.py``), densified point clouds (``models/densify.py``) and the mapper's
``save_model`` / ``load_model`` against the JAX package's.

- Byte equality: ``write_ply``, ``save_gaussian_ply``, ``merge_gaussian_ply``,
  ``write_mesh`` and ``save_densified_ply`` write the same bytes as the JAX
  functions on the same arrays, and the readers return equal arrays.
- ``Mapper.save_model``: for the same map (half unstable, half stable, at
  scattered slots), the port writes the JAX package's file names and bytes.
- ``load_model`` both ways: a checkpoint the JAX package wrote loads into the
  port and renders what the JAX package renders from it, and the reverse;
  float outputs within 1e-5 (the K1 twin's tolerance against the JAX blend,
  tests/test_torch_rasterize.py), index maps equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

from rtgslam_tpu.models import densify as jdensify
from rtgslam_tpu.slam import Mapper as JaxMapper
from rtgslam_tpu.utils import ply as jply

from rtgslam_torch.models import densify as tdensify
from rtgslam_torch.slam.mapper import Mapper
from rtgslam_torch.utils import ply as tply

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5
H, W = 48, 64


def _write_both(tmp_path, name, fn_jax, fn_port, *args, **kw):
    a, b = str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}")
    fn_jax(a, *args, **kw)
    fn_port(b, *args, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), name
    return a, b


def test_ply_functions_write_jax_bytes(tmp_path):
    g = tp.random_gaussians(257)
    cols = {"x": g["xyz"][:, 0], "nx": g["xyz"][:, 1], "w": g["opacity"][:, 0]}
    a, b = _write_both(tmp_path, "cols.ply", jply.write_ply, tply.write_ply, cols)
    for k, v in jply.read_ply(a).items():
        np.testing.assert_array_equal(tply.read_ply(b)[k], v)

    for conf in (g["confidence"], None):
        a, b = _write_both(tmp_path, f"g{conf is None}.ply", jply.save_gaussian_ply,
                           tply.save_gaussian_ply, g["xyz"], g["features_dc"],
                           g["features_rest"], g["opacity"], g["scaling"],
                           g["rotation"], conf)
        ref, got = jply.read_gaussian_ply(a), tply.read_gaussian_ply(b)
        assert sorted(got) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    g2 = tp.random_gaussians(31, seed=1)
    jply.save_gaussian_ply(str(tmp_path / "second.ply"), g2["xyz"], g2["features_dc"],
                           g2["features_rest"], g2["opacity"], g2["scaling"],
                           g2["rotation"], g2["confidence"])
    first = str(tmp_path / "jax_gFalse.ply")
    _write_both(tmp_path, "merge.ply", lambda out: jply.merge_gaussian_ply(
        first, str(tmp_path / "second.ply"), out), lambda out: tply.merge_gaussian_ply(
        first, str(tmp_path / "second.ply"), out))


def test_ascii_ply_and_mesh_read_like_jax(tmp_path):
    path = tmp_path / "ascii.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                    "property float y\nproperty float z\nend_header\n"
                    "0 0 1\n1 0.5 2\n-1 2 3.25\n")
    ref, got = jply.read_ply(str(path)), tply.read_ply(str(path))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (25, 3)).astype(np.int32)
    a, b = _write_both(tmp_path, "mesh.ply", jply.write_mesh, tply.write_mesh,
                       verts, faces)
    (rv, rf), (gv, gf) = jply.read_mesh(a), tply.read_mesh(b)
    np.testing.assert_array_equal(gv, rv)
    np.testing.assert_array_equal(gf, rf)


@pytest.mark.parametrize("sigma,circle_num,levels", [(1, 30, 5), (2, 8, 3)])
def test_densified_ply_writes_jax_bytes(tmp_path, sigma, circle_num, levels):
    g = tp.random_gaussians(400, seed=3)
    _write_both(tmp_path, f"dense_{sigma}.ply", jdensify.save_densified_ply,
                tdensify.save_densified_ply, g["xyz"], g["scaling"],
                g["rotation"], sigma=sigma, circle_num=circle_num, levels=levels)


# ---- mapper checkpoints ------------------------------------------------------

@pytest.fixture(scope="module")
def mapped(base_args):
    return tp.mappers_with_same_map(base_args, H, W)


CKPT_SUFFIXES = (".ply", "_stable.ply", "_sibr.ply", "_stable_sibr.ply",
                 "_merge.ply")


def test_save_model_writes_jax_names_and_bytes(mapped, tmp_path):
    _, _, jm, pm = mapped
    jm.save_path, pm.save_path = str(tmp_path / "jax"), str(tmp_path / "port")
    jm.time = pm.time = 7
    jm.save_model()
    pm.save_model()
    names = sorted(os.listdir(tmp_path / "jax" / "save_model" / "frame_0007"))
    assert names == sorted("iter_0000" + s for s in CKPT_SUFFIXES)
    assert sorted(os.listdir(tmp_path / "port" / "save_model" / "frame_0007")) == names
    for n in names:
        a = (tmp_path / "jax" / "save_model" / "frame_0007" / n).read_bytes()
        b = (tmp_path / "port" / "save_model" / "frame_0007" / n).read_bytes()
        assert a == b, n
    snap = pm.snapshot_host()
    assert snap["unstable"]["xyz"].shape == (150, 3) and snap["iter"] == 0


def _render_jax(args, cam, ply):
    m = JaxMapper(args)
    m.load_model(ply)
    m._ensure_settings(cam)
    return {k: np.asarray(v) for k, v in m._render(cam.device_dict(), "global").items()}


def _render_port(args, cam, ply):
    m = Mapper(args, "cpu")
    m.load_model(ply)
    m._ensure_settings(cam)
    return {k: v.numpy() for k, v in m._render(
        {k: torch.as_tensor(np.asarray(v, np.float32))
         for k, v in cam.device_dict().items()}).items()}


def _same_render(got, ref):
    for k in ("render", "depth", "normal", "T_map", "color_hit_weight",
              "depth_hit_weight"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=ATOL, err_msg=k)
    for k in ("color_index_map", "depth_index_map"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert int(got["overflow"]) == int(ref["overflow"]) == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_loads_and_renders_across_packages(mapped, tmp_path, writer):
    """A checkpoint written by one package loads into the other, and both
    packages render the same image from it."""
    args, cam, jm, pm = mapped
    base = str(tmp_path / "iter_0000")
    (jm if writer == "jax" else pm).save_model(path=base)
    for suffix in ("_merge.ply", "_stable.ply"):
        ref = _render_jax(args, cam, base + suffix)
        got = _render_port(args, cam, base + suffix)
        assert float((got["T_map"] < 0.5).mean()) > 0.05   # something drawn
        _same_render(got, ref)
