"""Row bands: a frame split into equal horizontal bands, each an exact
pinhole camera (numpy copy of ``rtgslam_tpu/data/bands.py``).

Cropping rows [r0, r0+bh) of an image is the same camera with the
principal point shifted (cy' = cy - r0) and the vertical field of view
rescaled to the band height (fy unchanged: FoVy' = focal2fov(fy, bh)).  A
world point on pixel (u, v) of the frame lands on (u, v - r0) of its band,
so mapping a frame band by band against the shared map touches the pixels
the whole frame would, in N pieces.  For the lower bands cy' is 0 or
negative, which ``Camera.intrinsic`` honours as given.

``slam_torch.py`` runs a config with ``frame_bands`` > 1 this way
(``slam/run.py::track_and_map_banded``): tracking once per frame on a
stride-downsampled copy, then every band mapped with the tracked pose.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils import geometry
from .camera import Camera


def downsample_camera(cam: Camera, stride: int, uid: Optional[int] = None) -> Camera:
    """Integer-stride downsample (``downsample_camera`` :35): the same field
    of view and metric depth, rows and columns subsampled with no averaging
    across depth edges.  Stride 1 returns ``cam`` itself."""
    if stride == 1:
        return cam
    h, w = cam.image_height, cam.image_width
    cx = cam.cx if cam.cx is not None else w / 2
    cy = cam.cy if cam.cy is not None else h / 2
    return Camera(
        uid=cam.uid if uid is None else uid,
        R=cam.R, T=cam.T, FoVx=cam.FoVx, FoVy=cam.FoVy,
        image=np.ascontiguousarray(cam.image[::stride, ::stride]),
        depth=np.ascontiguousarray(cam.depth[::stride, ::stride]),
        image_name=cam.image_name, cx=cx / stride, cy=cy / stride,
        timestamp=cam.timestamp, depth_scale=cam.depth_scale,
        pose_gt=cam.pose_gt,
    )


def split_bands(cam: Camera, n_bands: int, rotate: int = 0) -> List[Camera]:
    """``n_bands`` equal row bands of ``cam`` (``split_bands`` :54; H must be
    a multiple of ``n_bands``), each an exact pinhole camera of the same
    pose and uid.

    ``rotate`` cycles the band order (band ``rotate % n`` first): the
    mapper's keyframe test passes at most one band per keyframe pose (the
    rest have zero pose delta), so rotating which band leads lets the
    keyframe store sample every band over time instead of always row 0.
    """
    if n_bands == 1:
        return [cam]
    h, w = cam.image_height, cam.image_width
    if h % n_bands:
        raise ValueError(f"H={h} not divisible by n_bands={n_bands}")
    bh = h // n_bands
    fy = geometry.fov2focal(cam.FoVy, h)
    cx = cam.cx if cam.cx is not None else w / 2
    cy = cam.cy if cam.cy is not None else h / 2
    bands = []
    for b in range(n_bands):
        r0 = b * bh
        bands.append(Camera(
            uid=cam.uid, R=cam.R, T=cam.T,
            FoVx=cam.FoVx, FoVy=geometry.focal2fov(fy, bh),
            image=np.ascontiguousarray(cam.image[r0:r0 + bh]),
            depth=np.ascontiguousarray(cam.depth[r0:r0 + bh]),
            image_name=f"{cam.image_name}#band{b}",
            cx=cx, cy=cy - r0,
            timestamp=cam.timestamp, depth_scale=cam.depth_scale,
            pose_gt=cam.pose_gt,
        ))
    k = rotate % n_bands
    return bands[k:] + bands[:k]
