"""The port's dataset readers, ``load_camera`` and ``FrameLoader``
(``rtgslam_torch/data/``) against the JAX package's on the same files.

Each layout case of ``tests/test_datasets.py`` is built once in a temporary
directory (the "ours" scene by the JAX ``write_scene``); both packages read
it, and every ``CameraInfo`` field, the scene's normalization and mesh path,
and every decoded frame (pixels, depth, pose, intrinsics) must be equal,
arrays exactly.  A downscaled load (``resolution: 2``) holds depth exactly
(INTER_NEAREST) and color to 2.4e-7 (INTER_AREA in float64 against
OpenCV's float32 sums).  The port's ``write_scene`` files decode to the
JAX one's arrays.
"""

import json
import struct

import cv2
import numpy as np
import pytest
import torch
import yaml

from rtgslam_tpu.config import GroupParams
from rtgslam_tpu.data import Dataset as JaxDataset
from rtgslam_tpu.data import load_camera as jax_load_camera
from rtgslam_tpu.data.loader import FrameLoader as JaxFrameLoader
from rtgslam_tpu.data.synthetic import write_scene as jax_write_scene

from rtgslam_torch.data.camera import CameraInfo, load_camera
from rtgslam_torch.data.dataset import Dataset
from rtgslam_torch.data.loader import FrameLoader
from rtgslam_torch.data.synthetic import write_scene

torch.set_num_threads(1)


def make_args(path, dtype, resolution=1):
    a = GroupParams()
    a.type = dtype
    a.source_path = path
    a.eval = False
    a.eval_llff = 8
    a.frame_start = 0
    a.frame_num = -1
    a.frame_step = 0
    a.resolution = resolution
    return a


# ---- the layouts of tests/test_datasets.py ------------------------------

def _ours(d, dtype="Ours"):
    jax_write_scene(str(d / "scene"), n_frames=4, H=48, W=64)
    return str(d / "scene"), dtype


def _replica(d):
    root = d / "Replica"
    scene = root / "room_test"
    (scene / "results").mkdir(parents=True)
    H, W = 32, 48
    poses = []
    for i in range(3):
        img = np.full((H, W, 3), 100 + i, np.uint8)
        img[::3, ::5] = 30 * i
        cv2.imwrite(str(scene / "results" / f"frame{i:06d}.jpg"), img)
        cv2.imwrite(str(scene / "results" / f"depth{i:06d}.png"),
                    np.full((H, W), 2000 + i, np.uint16))
        pose = np.eye(4)
        pose[0, 3] = i * 0.1
        poses.append(pose)
    with open(scene / "traj.txt", "w") as f:
        for p in poses:
            f.write(" ".join(map(str, p.reshape(-1))) + "\n")
    with open(root / "cam_params.json", "w") as f:
        json.dump({"camera": {"fx": 40.0, "cx": W / 2, "cy": H / 2,
                              "scale": 1000.0, "h": H, "w": W}}, f)
    return str(scene), "Replica"


def _tum_files(d, rgb_ts, dep_ts, gt, H, W, cfg, write=cv2.imwrite):
    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir()
    rgb_lines, dep_lines = ["# color images"], ["# depth images"]
    rng = np.random.default_rng(0)
    for t in rgb_ts:
        write(str(d / "rgb" / f"{t:.6f}.png"),
              rng.integers(0, 256, (H, W, 3)).astype(np.uint8))
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
    for t in dep_ts:
        write(str(d / "depth" / f"{t:.6f}.png"),
              (5000 + rng.integers(0, 400, (H, W))).astype(np.uint16))
        dep_lines.append(f"{t:.6f} depth/{t:.6f}.png")
    (d / "rgb.txt").write_text("\n".join(rgb_lines))
    (d / "depth.txt").write_text("\n".join(dep_lines))
    (d / "groundtruth.txt").write_text("\n".join(gt))
    (d / "config.yaml").write_text(yaml.safe_dump(cfg))
    return str(d), "TUM"


def _tum(d):
    ts = [i * 0.5 for i in range(3)]
    gt = ["# header"] + [f"{t:.6f} {i*0.01} 0 0 0 0 0 1" for i, t in enumerate(ts)]
    return _tum_files(d / "tum_seq", ts, ts, gt, 32, 48, {
        "fx": 40.0, "fy": 40.0, "cx": 24.0, "cy": 16.0,
        "crop_edge": 0, "depth_scale": 5000.0})


def _tum_association(d):
    rgb_ts = [1305031452.791720, 1305031452.823674, 1305031452.859642,
              1305031452.891726]
    dep_ts = [1305031452.816237, 1305031452.849269, 1305031452.915980]
    gt = ["# ground truth trajectory",
          "1305031452.7916 1.2334 -0.0113 1.6941 0.7907 0.4393 -0.1770 -0.3879",
          "1305031452.8234 1.2335 -0.0114 1.6939 0.7908 0.4392 -0.1770 -0.3879",
          "1305031452.8596 1.2336 -0.0115 1.6937 0.7909 0.4391 -0.1771 -0.3878",
          "1305031452.8918 1.2337 -0.0116 1.6935 0.7910 0.4390 -0.1771 -0.3878"]
    # depth PNGs with OpenCV's adaptive filters, as TUM's are
    def write(path, img):
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    return _tum_files(d / "fr1_desk", rgb_ts, dep_ts, gt, 32, 48, {
        "fx": 517.3, "fy": 516.5, "cx": 318.6, "cy": 255.3,
        "crop_edge": 0, "depth_scale": 5000.0}, write)


def _tum_drops_unmatched(d):
    rgb_ts = [1305031453.000000, 1305031453.200000]
    gt = ["# gt"] + [f"{t:.6f} 0 0 0 0 0 0 1" for t in rgb_ts]
    return _tum_files(d / "tum_gap", rgb_ts, [1305031453.010000], gt, 32, 48, {
        "fx": 517.3, "fy": 516.5, "cx": 318.6, "cy": 255.3,
        "crop_edge": 0, "depth_scale": 5000.0})


def _tum_crop_edge(d):
    t = 1305031452.791720
    return _tum_files(d / "tum_crop", [t], [t], ["# gt", f"{t:.6f} 0 0 0 0 0 0 1"],
                      48, 64, {"fx": 40.0, "fy": 40.0, "cx": 32.0, "cy": 24.0,
                               "crop_edge": 8, "depth_scale": 5000.0})


def _blender(d):
    d = d / "lego"
    (d / "train").mkdir(parents=True)
    frames = []
    for i in range(2):
        cv2.imwrite(str(d / "train" / f"r_{i}.png"),
                    np.full((32, 40, 3), 60 * i, np.uint8))
        pose = np.eye(4)
        pose[2, 3] = 2.0 + i
        frames.append({"file_path": f"train/r_{i}", "transform_matrix": pose.tolist()})
    (d / "transforms_train.json").write_text(json.dumps(
        {"camera_angle_x": 0.7, "frames": frames}))
    return str(d), "Blender"


def _colmap_text(d):
    d = d / "colmap_scene"
    (d / "sparse" / "0").mkdir(parents=True)
    (d / "images").mkdir()
    cv2.imwrite(str(d / "images" / "img0.jpg"), np.full((32, 32, 3), 90, np.uint8))
    (d / "sparse" / "0" / "cameras.txt").write_text(
        "# cameras\n1 PINHOLE 32 32 40.0 40.0 16.0 16.0\n")
    (d / "sparse" / "0" / "images.txt").write_text(
        "# images\n1 1 0 0 0 0.1 0.2 0.3 1 img0.jpg\n0 0 0\n")
    return str(d), "Colmap"


def _colmap_binary(d):
    d = d / "colmap_bin"
    (d / "sparse" / "0").mkdir(parents=True)
    (d / "images").mkdir()
    cv2.imwrite(str(d / "images" / "img0.jpg"), np.full((32, 32, 3), 90, np.uint8))
    with open(d / "sparse" / "0" / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 0, 32, 32))
        f.write(struct.pack("<3d", 40.0, 16.0, 16.0))
    with open(d / "sparse" / "0" / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<i", 7))
        f.write(struct.pack("<7d", 0.9, 0.1, -0.3, 0.2, 0.1, 0.2, 0.3))
        f.write(struct.pack("<i", 1))
        f.write(b"img0.jpg\x00")
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<ddq", 1.0, 2.0, -1) * 2)
    return str(d), "Colmap"


LAYOUTS = {
    "ours": _ours,
    "scannetpp": lambda d: _ours(d, "Scannetpp"),
    "replica": _replica,
    "tum": _tum,
    "tum_association": _tum_association,
    "tum_drops_unmatched": _tum_drops_unmatched,
    "tum_crop_edge": _tum_crop_edge,
    "blender": _blender,
    "colmap_text": _colmap_text,
    "colmap_binary": _colmap_binary,
}


def _same_value(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.array_equal(a, b), what
    else:
        assert a == b and type(a) is type(b), (what, a, b)


def _same_camera(cam, ref, what, color_atol=0.0):
    for k in ("uid", "R", "T", "FoVx", "FoVy", "image_name", "cx", "cy",
              "timestamp", "depth_scale", "pose_gt", "image_width",
              "image_height"):
        _same_value(getattr(cam, k), getattr(ref, k), f"{what}.{k}")
    np.testing.assert_array_equal(cam.intrinsic, ref.intrinsic)
    assert cam.image.dtype == ref.image.dtype and cam.depth.dtype == ref.depth.dtype
    np.testing.assert_allclose(cam.image, ref.image, rtol=0, atol=color_atol)
    np.testing.assert_array_equal(cam.depth, ref.depth)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_reader_and_frames_equal_jax(tmp_path, layout):
    path, dtype = LAYOUTS[layout](tmp_path)
    args = make_args(path, dtype)
    ref, got = JaxDataset(args), Dataset(args)
    assert len(got) == len(ref) > 0
    assert got.mesh_path == ref.mesh_path
    assert got.cameras_extent == ref.cameras_extent
    np.testing.assert_array_equal(got.scene_info.nerf_normalization["translate"],
                                  ref.scene_info.nerf_normalization["translate"])
    assert len(got.scene_info.test_cameras) == len(ref.scene_info.test_cameras)
    for info, rinfo in zip(got.scene_info.train_cameras, ref.scene_info.train_cameras):
        assert isinstance(info, CameraInfo)
        for k in rinfo._fields:
            _same_value(getattr(info, k), getattr(rinfo, k), f"{layout}.{k}")
        _same_camera(load_camera(args, info.uid, info),
                     jax_load_camera(args, rinfo.uid, rinfo), layout)


@pytest.mark.parametrize("layout", ["ours", "tum_crop_edge"])
def test_downscaled_load_matches_jax(tmp_path, layout):
    path, dtype = LAYOUTS[layout](tmp_path)
    args = make_args(path, dtype, resolution=2)
    info = Dataset(args).scene_info.train_cameras[-1]
    rinfo = JaxDataset(args).scene_info.train_cameras[-1]
    cam, ref = load_camera(args, 0, info), jax_load_camera(args, 0, rinfo)
    assert cam.image.shape[0] * 2 == info.height
    _same_camera(cam, ref, layout, color_atol=2.4e-7)


def test_mixed_resolution_streams_match_jax(tmp_path):
    """Color at a higher resolution than depth: no crop (test_datasets.py
    :315), in both packages."""
    from rtgslam_tpu.data.dataset import CameraInfo as JaxCameraInfo

    img = np.random.default_rng(0).uniform(0, 255, (72, 128, 3)).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "c.png"), img)
    cv2.imwrite(str(tmp_path / "d.png"), np.full((58, 64), 1000, np.uint16))
    fields = dict(uid=0, R=np.eye(3), T=np.zeros(3), FovX=1.0, FovY=1.0,
                  image_path=str(tmp_path / "c.png"),
                  depth_path=str(tmp_path / "d.png"), image_name="c", width=64,
                  height=58, cx=32.0, cy=29.0, timestamp=0.0,
                  depth_scale=1000.0, pose_gt=np.eye(4))
    args = make_args(str(tmp_path), "Ours")
    cam = load_camera(args, 0, CameraInfo(**fields))
    ref = jax_load_camera(args, 0, JaxCameraInfo(**fields))
    assert cam.image.shape[:2] == (72, 128) and cam.depth.shape[:2] == (58, 64)
    _same_camera(cam, ref, "mixed")


def test_frame_loader_matches_jax(tmp_path):
    path, dtype = _ours(tmp_path)
    args = make_args(path, dtype)
    infos = Dataset(args).scene_info.train_cameras
    rinfos = JaxDataset(args).scene_info.train_cameras
    loader = FrameLoader(args, infos, prefetch=2, workers=2)
    ref_loader = JaxFrameLoader(args, rinfos, prefetch=2, workers=2)
    try:
        got, ref = list(loader), list(ref_loader)
    finally:
        loader.close()
        ref_loader.close()
    assert [c.uid for c in got] == [c.uid for c in ref] == list(range(len(infos)))
    for cam, rcam in zip(got, ref):
        _same_camera(cam, rcam, f"frame {cam.uid}")
        assert isinstance(cam.image, np.ndarray)   # decoded on the host only
    assert sorted(loader.decode_ms) == list(range(len(infos)))
    assert not any(w.is_alive() for w in loader._workers)


def test_write_scene_decodes_like_jax(tmp_path):
    jax_write_scene(str(tmp_path / "jax"), n_frames=3, H=40, W=56)
    write_scene(str(tmp_path / "port"), n_frames=3, H=40, W=56)
    for sub, ext in (("color", "png"), ("depth", "png")):
        for i in range(3):
            ref = cv2.imread(str(tmp_path / "jax" / sub / f"{i}.{ext}"),
                             cv2.IMREAD_UNCHANGED)
            got = cv2.imread(str(tmp_path / "port" / sub / f"{i}.{ext}"),
                             cv2.IMREAD_UNCHANGED)
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)
    for name in ("intrinsic/intrinsic_depth.txt", "pose/0.txt", "pose/2.txt"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
