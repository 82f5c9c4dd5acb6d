"""Camera model.

Numpy copy of ``rtgslam_tpu/data/camera.py`` (``Camera``), which imports
JAX through ``rtgslam_tpu.utils``.  ``R`` is the camera-to-world rotation,
``T`` the world-to-camera translation (colmap convention), as in the
reference ``scene/cameras.py``.  ``device_dict`` gives the small pose and
intrinsic tensors the render and track steps take.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..utils import geometry


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

    def update_pose(self, pose_c2w: np.ndarray) -> None:
        """Set the pose from a camera-to-world matrix (reference
        ``cameras.py:121-123``)."""
        pose_w2c = np.linalg.inv(pose_c2w)
        self.R = pose_w2c[:3, :3].transpose()
        self.T = pose_w2c[:3, 3]

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
