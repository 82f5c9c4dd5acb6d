"""Camera model.

Numpy copy of ``rtgslam_tpu/data/camera.py`` (``CameraInfo``, ``Camera``,
``load_camera``), which imports JAX through ``rtgslam_tpu.utils``.  ``R``
is the camera-to-world rotation, ``T`` the world-to-camera translation
(colmap convention), as in the reference ``scene/cameras.py``.
``device_dict`` gives the small pose and intrinsic tensors the render and
track steps take.  ``load_camera`` decodes with ``utils/image_io.py`` in
place of OpenCV.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils import geometry, image_io


class CameraInfo(NamedTuple):
    """Static description of one frame as produced by dataset readers."""

    uid: int
    R: np.ndarray
    T: np.ndarray
    FovX: float
    FovY: float
    image_path: str
    depth_path: str
    image_name: str
    width: int
    height: int
    cx: float
    cy: float
    timestamp: float
    depth_scale: float
    pose_gt: np.ndarray


@dataclass
class Camera:
    uid: int
    R: np.ndarray
    T: np.ndarray
    FoVx: float
    FoVy: float
    image: Optional[np.ndarray]  # [H, W, 3] float32 in [0,1]
    depth: Optional[np.ndarray]  # [H, W, 1] float32 (metres)
    image_name: str = ""
    # None = principal point at the image centre
    cx: Optional[float] = None
    cy: Optional[float] = None
    timestamp: float = 0.0
    depth_scale: float = 1.0
    pose_gt: np.ndarray = field(default_factory=lambda: np.eye(4))

    def __post_init__(self):
        if self.image is not None:
            self.image_height, self.image_width = self.image.shape[:2]

    @property
    def w2c(self) -> np.ndarray:
        return geometry.world_to_view(self.R, self.T)

    @property
    def c2w(self) -> np.ndarray:
        return np.linalg.inv(self.w2c)

    @property
    def camera_center(self) -> np.ndarray:
        return self.c2w[:3, 3]

    def update(self, R: np.ndarray, T: np.ndarray) -> None:
        self.R = R
        self.T = T

    def update_pose(self, pose_c2w: np.ndarray) -> None:
        """Set the pose from a camera-to-world matrix (reference
        ``cameras.py:121-123``)."""
        pose_w2c = np.linalg.inv(pose_c2w)
        self.update(pose_w2c[:3, :3].transpose(), pose_w2c[:3, 3])

    @property
    def intrinsic(self) -> np.ndarray:
        w, h = self.image_width, self.image_height
        fx = geometry.fov2focal(self.FoVx, w)
        fy = geometry.fov2focal(self.FoVy, h)
        cx = self.cx if self.cx is not None else w / 2
        cy = self.cy if self.cy is not None else h / 2
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float32)

    def device_dict(self, device="cpu") -> dict:
        """w2c [4,4], K [3,3] and campos [3] as float32 tensors."""
        return {
            "w2c": torch.as_tensor(np.asarray(self.w2c, np.float32), device=device),
            "K": torch.as_tensor(self.intrinsic, device=device),
            "campos": torch.as_tensor(
                np.asarray(self.camera_center, np.float32), device=device),
        }

    def drop_images(self) -> "Camera":
        """Clone without the pixel payload (keyframe bookkeeping)."""
        clone = Camera(
            uid=self.uid, R=self.R, T=self.T, FoVx=self.FoVx, FoVy=self.FoVy,
            image=None, depth=None, image_name=self.image_name, cx=self.cx,
            cy=self.cy, timestamp=self.timestamp, depth_scale=self.depth_scale,
            pose_gt=self.pose_gt,
        )
        clone.image_height, clone.image_width = self.image_height, self.image_width
        return clone


def load_camera(args, uid: int, info: CameraInfo, resolution_scale: float = 1.0) -> Camera:
    """Load a frame's RGBD payload into a ``Camera`` (``load_camera`` :166,
    reference ``utils/camera_utils.py:22-77``); numpy arrays only, the
    device copies happen where the frame is used."""
    image = image_io.imread(info.image_path)
    image = image.astype(np.float32) / 255.0

    if info.depth_path and info.depth_path.endswith(".npy"):
        depth = np.load(info.depth_path).astype(np.float32)
    elif info.depth_path:
        depth = image_io.imread(info.depth_path).astype(np.float32)
    else:
        depth = np.ones(image.shape[:2], dtype=np.float32)
    depth = depth / info.depth_scale

    # crop_edge: the reader already shrank width/height/cx/cy (TUM
    # config.yaml crop_edge) — recover the per-side margin from the shape
    # delta so pixels and intrinsics agree.  Per array, and only when BOTH
    # axes carry the same even margin (color and depth streams may have
    # different native resolutions).
    def _maybe_crop(arr):
        ch, cw = arr.shape[0] - info.height, arr.shape[1] - info.width
        if ch > 0 and ch == cw and ch % 2 == 0:
            c = ch // 2
            return arr[c:-c, c:-c]
        return arr

    image = _maybe_crop(image)
    depth = _maybe_crop(depth)

    resolution = getattr(args, "resolution", 1)
    scale = resolution * resolution_scale if resolution in (1, 2, 4, 8) else resolution_scale
    if scale != 1:
        new_w, new_h = round(image.shape[1] / scale), round(image.shape[0] / scale)
        image = image_io.resize_area(image, new_w, new_h)
        depth = image_io.resize_nearest(depth, new_w, new_h)

    return Camera(
        uid=uid,
        R=info.R,
        T=info.T,
        FoVx=info.FovX,
        FoVy=info.FovY,
        image=np.clip(image[..., :3], 0.0, 1.0),
        depth=depth[..., None] if depth.ndim == 2 else depth,
        image_name=info.image_name,
        cx=info.cx / resolution_scale,
        cy=info.cy / resolution_scale,
        timestamp=info.timestamp,
        depth_scale=info.depth_scale,
        pose_gt=info.pose_gt,
    )
