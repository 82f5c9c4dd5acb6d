"""The port's evaluation (``rtgslam_torch/slam/eval.py``) against the JAX
package's on the same render, map and mesh.

- ``eval_picture`` on one JAX render: every metric within 1e-5; the
  pictures are PNG (the JAX package writes JPEG, which is lossy): the color
  picture holds exactly the gt | render bytes, the depth picture OpenCV's
  JET of them within one level.
- ``eval_frame`` on the same map in both mappers: the same metric keys,
  values within 1e-5, at the mapper's opaque threshold and at the eval one
  (0.5), and its per-frame JSON.
- ``eval_pcd`` / ``sample_mesh_surface``: pure numpy + scipy, equal to the
  JAX package's results exactly, with and without faces.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from rtgslam_tpu.slam import eval as jeval
from rtgslam_tpu.utils.ply import write_mesh

from rtgslam_torch.slam import eval as teval
from rtgslam_torch.utils import image_io

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)
ATOL = 1e-5
H, W = 48, 64


@pytest.fixture(scope="module")
def mapped(base_args):
    return tp.mappers_with_same_map(base_args, H, W)


def _port_frame(cam):
    return tp.port_cameras([cam])[0]


def _close(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= ATOL, (k, got[k], ref[k])


def test_eval_picture_matches_jax(mapped, tmp_path):
    _, cam, jm, _ = mapped
    out = {k: np.asarray(v) for k, v in jm._render(cam.device_dict(), "global").items()}
    ref = jeval.eval_picture(out, cam.image, cam.depth)
    tout = {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
    got = teval.eval_picture(tout, cam.image, cam.depth, str(tmp_path), "f", 0.3, 5.0)
    _close(got, ref)

    img = out["render"].clip(0, 1)
    color = image_io.read_png(str(tmp_path / "f_color.png"))
    np.testing.assert_array_equal(
        color, (np.concatenate([cam.image, img], axis=1) * 255).astype(np.uint8))
    row = np.concatenate([cam.depth[..., 0], out["depth"][..., 0]], axis=1)
    dn = ((row - 0.3) / 4.7).clip(0, 1)
    jet = cv2.applyColorMap((dn * 255).astype(np.uint8), cv2.COLORMAP_JET)[..., ::-1]
    depth = image_io.read_png(str(tmp_path / "f_depth.png"))
    assert np.abs(depth.astype(int) - jet.astype(int)).max() <= 1


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_eval_frame_matches_jax(mapped, tmp_path, threshold):
    _, cam, jm, pm = mapped
    ref = jeval.eval_frame(jm, cam, str(tmp_path / "jax"), 0.3, 5.0,
                           save_picture=True, opaque_threshold_eval=threshold)
    got = teval.eval_frame(pm, _port_frame(cam), str(tmp_path / "port"), 0.3, 5.0,
                           save_picture=True, opaque_threshold_eval=threshold)
    _close(got, ref)
    with open(tmp_path / "port" / "frame_0000.json") as f:
        _close(json.load(f), ref)
    assert sorted(os.listdir(tmp_path / "port")) == [
        "frame_0000.json", "frame_0000_color.png", "frame_0000_depth.png"]
    assert sorted(os.listdir(tmp_path / "jax")) == [
        "frame_0000.json", "frame_0000_color.jpg", "frame_0000_depth.jpg"]


def test_eval_frame_geometry_matches_jax(mapped, tmp_path):
    """``run_pcd``: the stable pool's centres (or a reconstruction PLY)
    against a GT mesh, in both packages."""
    _, cam, jm, pm = mapped
    rng = np.random.default_rng(0)
    verts = rng.uniform([-1.2, -0.9, 1.5], [1.2, 0.9, 3.5], (60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (80, 3)).astype(np.int32)
    mesh = str(tmp_path / "mesh.ply")
    write_mesh(mesh, verts, faces)
    kw = dict(run_pcd=True, pcd_gt_path=mesh)
    ref = jeval.eval_frame(jm, cam, **kw)
    got = teval.eval_frame(pm, _port_frame(cam), **kw)
    _close(got, ref)
    assert {"accuracy_cm", "completion_cm", "f1"} <= set(got)


@pytest.mark.parametrize("with_faces", [True, False])
def test_eval_pcd_equals_jax(tmp_path, with_faces):
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(200, 3)).astype(np.float32)
    faces = rng.integers(0, 200, (300, 3)).astype(np.int32)
    mesh = str(tmp_path / "gt.ply")
    if with_faces:
        write_mesh(mesh, verts, faces)
    else:
        from rtgslam_tpu.utils.ply import write_ply
        write_ply(mesh, {"x": verts[:, 0], "y": verts[:, 1], "z": verts[:, 2]})
    pts = (verts[:150] + rng.normal(0, 0.02, (150, 3))).astype(np.float32)
    assert teval.eval_pcd(pts, mesh, sample=5000) == jeval.eval_pcd(pts, mesh, sample=5000)
    np.testing.assert_array_equal(teval.sample_mesh_surface(verts, faces, 777, seed=3),
                                  jeval.sample_mesh_surface(verts, faces, 777, seed=3))


def _seeded_lpips_npz(path, seed=0):
    """LPIPS-alex weights made from a seed, in the exact npz layout of
    ``scripts/export_lpips_weights.py`` (AlexNet's 5 feature convs, OIHW,
    and the 5 non-negative linear heads)."""
    rng = np.random.default_rng(seed)
    shapes = [(64, 3, 11), (192, 64, 5), (384, 192, 3), (256, 384, 3),
              (256, 256, 3)]
    arrays = {}
    for i, (o, c, k) in enumerate(shapes):
        arrays[f"conv{i}_w"] = rng.normal(0, np.sqrt(2.0 / (c * k * k)),
                                          (o, c, k, k)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(0, 0.05, o).astype(np.float32)
        arrays[f"lin{i}"] = np.abs(rng.normal(0, 0.1, o)).astype(np.float32)
    np.savez(path, **arrays)
    return str(path)


def test_lpips_weights_refused(mapped, monkeypatch):
    """A weights path that names no file is refused as in the JAX package:
    the column is left out (never NaN)."""
    _, cam, _, pm = mapped
    monkeypatch.setenv("LPIPS_WEIGHTS", "/nonexistent/alexnet.npz")
    assert "lpips" not in teval.eval_frame(pm, _port_frame(cam))


def test_lpips_matches_jax(mapped, tmp_path, monkeypatch):
    """``models/lpips.py`` on seeded weights: the metric alone and in
    ``eval_frame`` within 1e-5 relative of the JAX package's (float32 convs
    summing in another order)."""
    from rtgslam_tpu.models import lpips as jlpips
    from rtgslam_torch.models import lpips as tlpips

    _, cam, jm, pm = mapped
    path = _seeded_lpips_npz(tmp_path / "lpips_seeded.npz")
    # the JAX package caches the first weights it reads for the process
    monkeypatch.setattr(jlpips, "_weights_cache", None)
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, cam.image.shape).astype(np.float32)
    want = jlpips.lpips(img, cam.image.astype(np.float32), path)
    got = tlpips.lpips(torch.from_numpy(img), torch.from_numpy(cam.image), path)
    assert want > 0 and abs(got - want) <= 1e-5 * want
    assert tlpips.lpips(torch.from_numpy(img), torch.from_numpy(img), path) == 0.0
    monkeypatch.setenv("LPIPS_WEIGHTS", path)
    ref = jeval.eval_frame(jm, cam)
    out = teval.eval_frame(pm, _port_frame(cam))
    assert abs(out["lpips"] - ref["lpips"]) <= 1e-5 * ref["lpips"]
