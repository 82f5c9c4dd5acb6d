"""Dataset readers: Replica, TUM-RGBD, ScanNet++/ours, Blender and Colmap
layouts.

Copy of ``rtgslam_tpu/data/dataset.py`` (which imports JAX through
``rtgslam_tpu.utils``), with image sizes read by ``utils/image_io.py`` in
place of OpenCV.  Produces lists of :class:`CameraInfo` with *paths*
(decode happens in ``load_camera`` / the prefetching loader) — unlike the
reference (``scene/dataset_readers.py``) which eagerly loads PIL images,
the reader stays metadata-only so frame decode can be overlapped with
device compute.

Format contracts (reference ``scene/dataset_readers.py``):
  Replica   results/frame*.jpg + results/depth*.png, traj.txt (4x4 rows,
            normalized to the first pose), ../cam_params.json (:774-845)
  TUM       rgb.txt/depth.txt/groundtruth.txt timestamp association,
            config.yaml intrinsics + crop_edge (:545-660)
  ours/     color/*.jpg|png, depth/*.png, pose/*.txt,
  Scannetpp intrinsic/intrinsic_depth.txt, depth_scale=1000 (:968-1073)
"""

from __future__ import annotations

import glob
import json
import os
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import yaml

from ..utils.geometry import focal2fov
from ..utils.image_io import image_size
from .camera import CameraInfo


class SceneInfo(NamedTuple):
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    mesh_path: Optional[str]


def _camera_infos(color_paths, depth_paths, poses, intrinsic, indices,
                  depth_scale, timestamps, crop_edge=0, image_hw=None) -> List[CameraInfo]:
    """Build CameraInfo records; pose convention: R = c2w rotation (stored
    transposed from w2c), T = w2c translation (reference
    ``readCameras``, dataset_readers.py:865-931)."""
    infos = []
    first_inv = np.eye(4)
    for order, idx in enumerate(indices):
        c2w = poses[idx]
        if order == 0:
            first_inv = np.linalg.inv(c2w)
        if np.isinf(c2w).any():
            continue
        c2w = first_inv @ c2w
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])
        T = w2c[:3, 3]

        fx, fy = intrinsic[0, 0], intrinsic[1, 1]
        cx, cy = intrinsic[0, 2] - crop_edge, intrinsic[1, 2] - crop_edge
        if image_hw is None:
            image_hw = image_size(depth_paths[idx])
        h, w = image_hw[0] - 2 * crop_edge, image_hw[1] - 2 * crop_edge
        infos.append(CameraInfo(
            uid=order,
            R=R,
            T=T,
            FovX=focal2fov(fx, w),
            FovY=focal2fov(fy, h),
            image_path=color_paths[idx],
            depth_path=depth_paths[idx],
            image_name=os.path.basename(color_paths[idx]).split(".")[0],
            width=w,
            height=h,
            cx=cx,
            cy=cy,
            timestamp=timestamps[idx],
            depth_scale=depth_scale,
            pose_gt=c2w,
        ))
    return infos


def _frame_indices(n_img: int, frame_start: int, frame_num: int, frame_step: int) -> List[int]:
    count = n_img if frame_num == -1 else min(frame_num, n_img)
    indices = [frame_start + i * (frame_step + 1) for i in range(count)]
    return [i for i in indices if i < n_img]


def _normalization(infos: List[CameraInfo]) -> dict:
    if not infos:
        return {"radius": 1.0, "translate": np.zeros(3)}
    centers = []
    for c in infos:
        w2c = np.eye(4)
        w2c[:3, :3] = c.R.T
        w2c[:3, 3] = c.T
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    radius = float(np.max(np.linalg.norm(centers - center, axis=1)) * 1.1) or 1.0
    return {"radius": radius, "translate": -center}


# ---------------------------------------------------------------------------
# Replica
# ---------------------------------------------------------------------------

def read_replica_scene(datapath, eval=False, llffhold=8, frame_start=0,
                       frame_num=-1, frame_step=0) -> SceneInfo:
    color_paths = sorted(glob.glob(f"{datapath}/results/frame*.jpg"))
    depth_paths = sorted(glob.glob(f"{datapath}/results/depth*.png"))
    n_img = len(color_paths)
    timestamps = [i / 30.0 for i in range(n_img)]

    with open(f"{datapath}/traj.txt") as f:
        lines = f.readlines()
    poses, first_inv = [], np.eye(4)
    for i in range(n_img):
        c2w = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
        if i == 0:
            first_inv = np.linalg.inv(c2w)
        poses.append(first_inv @ c2w)

    with open(os.path.join(datapath, "../cam_params.json")) as f:
        cam = json.load(f)["camera"]
    intrinsic = np.array([[cam["fx"], 0, cam["cx"]],
                          [0, cam["fx"], cam["cy"]],
                          [0, 0, 1.0]])
    indices = _frame_indices(n_img, frame_start, frame_num, frame_step)
    infos = _camera_infos(color_paths, depth_paths, poses, intrinsic, indices,
                          cam["scale"], timestamps, image_hw=(cam["h"], cam["w"]))
    if eval:
        train = [c for i, c in enumerate(infos) if (i + 1) % llffhold != 0]
        test = [c for i, c in enumerate(infos) if (i + 1) % llffhold == 0]
    else:
        train, test = infos, []
    mesh_path = os.path.join(datapath, os.path.basename(datapath) + ".ply")
    return SceneInfo(train, test, _normalization(train), mesh_path)


# ---------------------------------------------------------------------------
# TUM RGBD
# ---------------------------------------------------------------------------

def read_tum_scene(datapath, eval=False, llffhold=8, frame_start=0,
                   frame_num=-1, frame_step=0) -> SceneInfo:
    from scipy.spatial.transform import Rotation

    def parse_list(path, skiprows=0):
        return np.loadtxt(path, delimiter=" ", dtype=np.str_, skiprows=skiprows,
                          ndmin=2)

    pose_file = os.path.join(datapath, "groundtruth.txt")
    if not os.path.isfile(pose_file):
        pose_file = os.path.join(datapath, "pose.txt")
    with open(os.path.join(datapath, "config.yaml")) as f:
        cfg = yaml.safe_load(f)
    intrinsic = np.array([[cfg["fx"], 0, cfg["cx"]],
                          [0, cfg["fy"], cfg["cy"]],
                          [0, 0, 1.0]])

    image_data = parse_list(os.path.join(datapath, "rgb.txt"))
    depth_data = parse_list(os.path.join(datapath, "depth.txt"))
    pose_data = parse_list(pose_file, skiprows=1)
    t_img = image_data[:, 0].astype(np.float64)
    t_dep = depth_data[:, 0].astype(np.float64)
    t_pose = pose_data[:, 0].astype(np.float64)
    pose_vecs = pose_data[:, 1:].astype(np.float64)

    assoc = []
    for i, t in enumerate(t_img):
        j = int(np.argmin(np.abs(t_dep - t)))
        k = int(np.argmin(np.abs(t_pose - t)))
        if abs(t_dep[j] - t) < 0.08 and abs(t_pose[k] - t) < 0.08:
            assoc.append((i, j, k))

    # keep ~frame_rate fps (drop near-duplicate stamps)
    keep = [0]
    for i in range(1, len(assoc)):
        if t_img[assoc[i][0]] - t_img[assoc[keep[-1]][0]] > 1.0 / 32:
            keep.append(i)

    indices = _frame_indices(len(keep), frame_start, frame_num, frame_step)
    color_paths, depth_paths, poses, timestamps = [], [], [], []
    for idx in indices:
        i, j, k = assoc[keep[idx]]
        color_paths.append(os.path.join(datapath, str(image_data[i, 1])))
        depth_paths.append(os.path.join(datapath, str(depth_data[j, 1])))
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_quat(pose_vecs[k][3:]).as_matrix()
        pose[:3, 3] = pose_vecs[k][:3]
        poses.append(pose)
        timestamps.append(float(t_img[i]))

    infos = _camera_infos(color_paths, depth_paths, poses, intrinsic,
                          list(range(len(poses))), cfg["depth_scale"], timestamps,
                          crop_edge=cfg.get("crop_edge", 0))
    if eval:
        train = [c for i, c in enumerate(infos) if (i + 1) % llffhold != 0]
        test = [c for i, c in enumerate(infos) if (i + 1) % llffhold == 0]
    else:
        train, test = infos, []
    return SceneInfo(train, test, _normalization(train), None)


# ---------------------------------------------------------------------------
# ours / ScanNet++ (color/ depth/ pose/ directory layout)
# ---------------------------------------------------------------------------

def read_ours_scene(datapath, eval=False, llffhold=8, frame_start=0,
                    frame_num=-1, frame_step=0, is_scannetpp=False) -> SceneInfo:
    def by_stem(path):
        return int(os.path.basename(path).split(".")[0])

    color_paths = sorted(
        glob.glob(f"{datapath}/color/*.jpg") + glob.glob(f"{datapath}/color/*.png"),
        key=by_stem,
    )
    depth_paths = sorted(glob.glob(f"{datapath}/depth/*.png"), key=by_stem)
    pose_paths = sorted(glob.glob(f"{datapath}/pose/*.txt"), key=by_stem)
    n_img = len(color_paths)
    timestamps = [(i + 1) / 30.0 for i in range(n_img)]
    poses = [np.loadtxt(p) for p in pose_paths]
    intrinsic = np.loadtxt(os.path.join(datapath, "intrinsic", "intrinsic_depth.txt"))

    indices = _frame_indices(n_img, frame_start, frame_num, frame_step)
    infos = _camera_infos(color_paths, depth_paths, poses, intrinsic, indices,
                          1000.0, timestamps)
    mesh_path = os.path.join(datapath, "mesh_aligned_cull.ply") if is_scannetpp else None
    return SceneInfo(infos, [], _normalization(infos), mesh_path)


# ---------------------------------------------------------------------------
# Blender (NeRF-synthetic transforms_*.json) — no depth; ones depth like the
# reference Camera fallback (cameras.py:73-78)
# ---------------------------------------------------------------------------

def read_blender_scene(datapath, eval=False, llffhold=8, frame_start=0,
                       frame_num=-1, frame_step=0) -> SceneInfo:
    import math

    def load_split(name):
        with open(os.path.join(datapath, f"transforms_{name}.json")) as f:
            meta = json.load(f)
        fovx = meta["camera_angle_x"]
        infos = []
        for order, fr in enumerate(meta["frames"]):
            c2w = np.array(fr["transform_matrix"])
            # blender->CV: flip y/z axes
            c2w[:3, 1:3] *= -1
            w2c = np.linalg.inv(c2w)
            path = os.path.join(datapath, fr["file_path"] + ".png")
            h, w = image_size(path)
            fovy = 2 * math.atan(math.tan(fovx / 2) * h / w)
            infos.append(CameraInfo(
                uid=order, R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3],
                FovX=fovx, FovY=fovy, image_path=path, depth_path="",
                image_name=os.path.basename(path).split(".")[0],
                width=w, height=h, cx=w / 2, cy=h / 2,
                timestamp=order / 30.0, depth_scale=1.0, pose_gt=c2w))
        return infos

    train = load_split("train")
    test = load_split("test") if os.path.exists(
        os.path.join(datapath, "transforms_test.json")) else []
    return SceneInfo(train, test, _normalization(train), None)


# ---------------------------------------------------------------------------
# Colmap (text sparse model: cameras.txt / images.txt)
# ---------------------------------------------------------------------------

# Colmap camera-model id -> (name, param count); binary model ids are fixed
# by colmap's src/base/camera_models.h (reference colmap_loader.py:28-45).
_COLMAP_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}


def _colmap_intrinsics(model: str, params) -> tuple:
    """(fx, fy, cx, cy) from a colmap camera row.  Single-focal models lead
    with (f, cx, cy, ...); every other model — including FOV, whose params
    are (fx, fy, cx, cy, omega) — leads with (fx, fy, cx, cy, ...)."""
    if model.startswith("SIMPLE_") or model in ("RADIAL", "RADIAL_FISHEYE"):
        return params[0], params[0], params[1], params[2]
    return params[0], params[1], params[2], params[3]


def _read_colmap_cameras(sparse: str) -> Dict[int, tuple]:
    """cameras.bin (preferred) or cameras.txt -> {cam_id: (w,h,fx,fy,cx,cy)}.

    Binary layout per colmap ``WriteCamerasBinary`` (reference
    ``scene/colmap_loader.py:258-289``): u64 count, then per camera
    i32 id, i32 model_id, u64 width, u64 height, f64 params[n]."""
    import struct

    cams = {}
    bin_path = os.path.join(sparse, "cameras.bin")
    if os.path.isfile(bin_path):
        with open(bin_path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
                name, n_params = _COLMAP_MODELS[model_id]
                params = struct.unpack("<" + "d" * n_params, f.read(8 * n_params))
                cams[cam_id] = (int(w), int(h)) + _colmap_intrinsics(name, params)
        return cams
    with open(os.path.join(sparse, "cameras.txt")) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cam_id, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
            params = list(map(float, parts[4:]))
            cams[cam_id] = (w, h) + _colmap_intrinsics(model, params)
    return cams


def _read_colmap_images(sparse: str) -> List[tuple]:
    """images.bin (preferred) or images.txt -> [(qvec, tvec, cam_id, name)].

    Binary layout per colmap ``WriteImagesBinary`` (reference
    ``scene/colmap_loader.py:212-255``): u64 count, then per image i32 id,
    f64 qw qx qy qz tx ty tz, i32 cam_id, name chars until NUL, u64 n_pts2D,
    n_pts2D x (f64 x, f64 y, i64 point3D_id) which we skip."""
    import struct

    out = []
    bin_path = os.path.join(sparse, "images.bin")
    if os.path.isfile(bin_path):
        with open(bin_path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                f.read(4)  # image_id
                qw, qx, qy, qz, tx, ty, tz = struct.unpack("<7d", f.read(56))
                (cam_id,) = struct.unpack("<i", f.read(4))
                name = b""
                while True:
                    c = f.read(1)
                    if c == b"\x00":
                        break
                    name += c
                (n_pts,) = struct.unpack("<Q", f.read(8))
                f.seek(24 * n_pts, 1)
                out.append(((qw, qx, qy, qz), (tx, ty, tz), cam_id,
                            name.decode("utf-8")))
        return out
    with open(os.path.join(sparse, "images.txt")) as f:
        lines = [l for l in f if not l.startswith("#") and l.strip()]
    for line in lines[::2]:  # every other line is 2D points
        parts = line.split()
        out.append((tuple(map(float, parts[1:5])),
                    tuple(map(float, parts[5:8])), int(parts[8]), parts[9]))
    return out


def read_colmap_scene(datapath, eval=False, llffhold=8, frame_start=0,
                      frame_num=-1, frame_step=0) -> SceneInfo:
    from scipy.spatial.transform import Rotation

    sparse = os.path.join(datapath, "sparse", "0")
    cams = _read_colmap_cameras(sparse)
    infos = []
    for order, (qvec, tvec_t, cam_id, name) in enumerate(_read_colmap_images(sparse)):
        qw, qx, qy, qz = qvec
        tvec = np.array(tvec_t)
        w, h, fx, fy, cx, cy = cams[cam_id]
        Rw2c = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
        c2w = np.eye(4)
        c2w[:3, :3] = Rw2c.T
        c2w[:3, 3] = -Rw2c.T @ tvec
        infos.append(CameraInfo(
            uid=order, R=Rw2c.T, T=tvec, FovX=focal2fov(fx, w),
            FovY=focal2fov(fy, h),
            image_path=os.path.join(datapath, "images", name), depth_path="",
            image_name=name.split(".")[0], width=w, height=h, cx=cx, cy=cy,
            timestamp=order / 30.0, depth_scale=1.0, pose_gt=c2w))
    infos.sort(key=lambda c: c.image_name)
    if eval:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []
    return SceneInfo(train, test, _normalization(train), None)


scene_load_callbacks: Dict[str, Callable[..., SceneInfo]] = {
    "Replica": read_replica_scene,
    "TUM": read_tum_scene,
    "Tum": read_tum_scene,
    "Ours": read_ours_scene,
    "ours": read_ours_scene,
    "Scannetpp": lambda *a, **k: read_ours_scene(*a, **k, is_scannetpp=True),
    "Blender": read_blender_scene,
    "Colmap": read_colmap_scene,
}


class Dataset:
    """Dataset facade dispatching on ``args.type`` (reference
    ``scene/__init__.py:16-72``)."""

    def __init__(self, args, shuffle=False, resolution_scales=(1.0,)):
        loader = scene_load_callbacks.get(args.type)
        if loader is None:
            raise ValueError(f"Could not recognize scene type: {args.type}")
        self.scene_info = loader(
            args.source_path, args.eval, args.eval_llff,
            args.frame_start, args.frame_num, args.frame_step,
        )
        self.cameras_extent = self.scene_info.nerf_normalization["radius"]
        self.mesh_path = self.scene_info.mesh_path

    def __len__(self):
        return len(self.scene_info.train_cameras)
