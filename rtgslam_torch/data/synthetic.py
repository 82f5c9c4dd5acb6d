"""Procedural synthetic RGBD scenes with analytic ground truth.

Numpy copy of ``rtgslam_tpu/data/synthetic.py`` (that module imports JAX
through ``rtgslam_tpu.utils``); ``make_cameras`` returns the same arrays.

A textured axis-aligned box room containing a few matte spheres, rendered by
exact ray casting (no rasterizer involvement), with a smooth interior camera
trajectory.  The repository ships no Replica/TUM data, so tests and runs use
this scene: exact depth + poses give analytic targets for ICP and the
renderer.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from .camera import Camera
from ..utils.geometry import focal2fov


@dataclass
class RoomScene:
    lo: np.ndarray = field(default_factory=lambda: np.array([0.0, 0.0, 0.0]))
    hi: np.ndarray = field(default_factory=lambda: np.array([4.0, 3.0, 4.0]))
    # spheres: (center xyz, radius, base rgb) — deliberately many, spread
    # through the room, so every viewpoint sees non-planar geometry (a bare
    # box room leaves point-to-plane ICP unconstrained along the walls)
    spheres: Tuple = (
        (np.array([1.2, 1.0, 1.4]), 0.45, np.array([0.85, 0.35, 0.25])),
        (np.array([2.9, 0.8, 2.8]), 0.35, np.array([0.25, 0.65, 0.85])),
        (np.array([2.0, 2.2, 1.0]), 0.30, np.array([0.40, 0.80, 0.35])),
        (np.array([0.7, 2.1, 2.9]), 0.40, np.array([0.80, 0.70, 0.30])),
        (np.array([3.3, 1.9, 1.2]), 0.35, np.array([0.55, 0.40, 0.80])),
        (np.array([1.0, 0.6, 3.2]), 0.30, np.array([0.30, 0.75, 0.70])),
        (np.array([3.1, 0.9, 0.8]), 0.40, np.array([0.85, 0.50, 0.60])),
        (np.array([0.6, 1.2, 0.7]), 0.35, np.array([0.45, 0.60, 0.85])),
        (np.array([2.2, 2.4, 3.1]), 0.30, np.array([0.70, 0.80, 0.45])),
        (np.array([1.7, 0.5, 2.2]), 0.25, np.array([0.90, 0.65, 0.35])),
        # NOTE: keep the camera orbit volume (room centre +-0.5m, y 1.3-1.9)
        # clear of geometry — a grazing pass puts gt depth below min_depth,
        # which no RGBD pipeline can map and which poisons depth-L1 eval
        (np.array([3.2, 2.0, 2.6]), 0.22, np.array([0.35, 0.55, 0.75])),
        (np.array([0.8, 2.4, 1.2]), 0.26, np.array([0.65, 0.45, 0.55])),
        # wall-mounted relief for the two view cones the orbit holds for
        # tens of frames (central hits near (2.2, 1.7, 4.0) and
        # (4.0, 1.5, 2.1)): a >=0.12 m depth-std floor in every view keeps
        # point-to-plane ICP observable — a bare wall is rank-deficient
        # in-plane, and 90 straight frames of it diverged 220-frame runs
        (np.array([2.55, 1.95, 3.72]), 0.26, np.array([0.75, 0.55, 0.40])),
        (np.array([3.74, 1.85, 2.50]), 0.24, np.array([0.40, 0.70, 0.60])),
    )
    # axis-aligned "furniture" boxes (lo, hi, base rgb): wall-to-wall depth
    # relief so point-to-plane ICP is observable from every viewpoint
    boxes: Tuple = (
        (np.array([0.0, 0.0, 0.0]), np.array([0.9, 0.8, 1.1]), np.array([0.75, 0.55, 0.35])),
        (np.array([3.1, 0.0, 2.9]), np.array([4.0, 1.3, 4.0]), np.array([0.35, 0.6, 0.5])),
        (np.array([1.6, 0.0, 3.4]), np.array([2.6, 0.6, 4.0]), np.array([0.55, 0.45, 0.7])),
        (np.array([0.0, 1.6, 1.6]), np.array([0.5, 2.4, 2.6]), np.array([0.65, 0.6, 0.3])),
        (np.array([3.5, 1.4, 0.0]), np.array([4.0, 2.2, 0.9]), np.array([0.5, 0.65, 0.75])),
        (np.array([1.3, 2.5, 0.0]), np.array([2.5, 3.0, 0.5]), np.array([0.7, 0.4, 0.45])),
        (np.array([0.0, 0.0, 2.4]), np.array([0.6, 0.5, 3.2]), np.array([0.45, 0.7, 0.4])),
        (np.array([2.9, 2.4, 1.5]), np.array([4.0, 3.0, 2.3]), np.array([0.6, 0.5, 0.65])),
        # wall shelves anchoring the long bare-wall view cones (see spheres)
        (np.array([1.80, 1.45, 3.70]), np.array([2.25, 1.80, 4.0]), np.array([0.55, 0.65, 0.45])),
        (np.array([3.70, 1.25, 1.75]), np.array([4.0, 1.65, 2.20]), np.array([0.70, 0.50, 0.55])),
    )

    # -- textures -----------------------------------------------------------
    def _wall_color(self, wall_id: np.ndarray, p: np.ndarray) -> np.ndarray:
        """Smooth per-wall procedural texture, C1-continuous (good for both
        photometric optimization and PSNR evaluation)."""
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        u = np.where(wall_id // 2 == 0, z, x)
        v = np.where(wall_id // 2 == 1, z, y)
        base = np.stack([
            0.55 + 0.18 * np.sin(2.1 * u + 0.7 * wall_id),
            0.50 + 0.18 * np.sin(1.7 * v + 1.9 * wall_id),
            0.45 + 0.18 * np.sin(1.3 * (u + v) + 3.1 * wall_id),
        ], axis=-1)
        detail = 0.08 * np.sin(9.0 * u)[..., None] * np.cos(7.0 * v)[..., None]
        return np.clip(base + detail, 0.03, 0.97)

    def _sphere_color(self, base: np.ndarray, p: np.ndarray, c: np.ndarray) -> np.ndarray:
        local = p - c
        swirl = 0.12 * np.sin(8.0 * local[..., 0] + 6.0 * local[..., 1])
        return np.clip(base + swirl[..., None], 0.03, 0.97)

    # -- ray casting --------------------------------------------------------
    def cast(self, origins: np.ndarray, dirs: np.ndarray):
        """Exact nearest-hit of rays against room walls + spheres.

        origins [..., 3], dirs [..., 3] (world, not necessarily unit).
        Returns (color [...,3], t [...], normal [...,3]) with t the ray
        parameter of the hit.
        """
        d = dirs
        safe_d = np.where(np.abs(d) < 1e-9, 1e-9, d)
        # walls seen from inside: positive-going rays hit the hi face
        t_axis = np.where(d > 0, (self.hi - origins) / safe_d,
                          (self.lo - origins) / safe_d)
        axis = np.argmin(t_axis, axis=-1)
        t_box = np.take_along_axis(t_axis, axis[..., None], axis=-1)[..., 0]
        # wall id: 2*axis + (1 if hi face else 0)
        d_axis = np.take_along_axis(d, axis[..., None], axis=-1)[..., 0]
        wall_id = 2 * axis + (d_axis > 0).astype(np.int64)
        p_box = origins + t_box[..., None] * d
        color = self._wall_color(wall_id, p_box)
        normal = np.zeros_like(d)
        sign = np.where(d_axis > 0, -1.0, 1.0)  # inward-facing
        np.put_along_axis(normal, axis[..., None], sign[..., None], axis=-1)

        t_best = t_box
        for lo, hi, base in self.boxes:
            # slab-method ray-AABB (rays start outside the furniture boxes)
            t1 = (lo - origins) / safe_d
            t2 = (hi - origins) / safe_d
            t_near = np.max(np.minimum(t1, t2), axis=-1)
            t_far = np.min(np.maximum(t1, t2), axis=-1)
            hit = (t_near < t_far) & (t_near > 1e-4) & (t_near < t_best)
            p_b = origins + t_near[..., None] * d
            # face axis = the slab that produced t_near
            axis_b = np.argmax(np.minimum(t1, t2), axis=-1)
            d_axis_b = np.take_along_axis(d, axis_b[..., None], axis=-1)[..., 0]
            n_b = np.zeros_like(d)
            np.put_along_axis(n_b, axis_b[..., None],
                              np.where(d_axis_b > 0, -1.0, 1.0)[..., None], axis=-1)
            swirl = 0.1 * np.sin(5.0 * p_b[..., 0] + 4.0 * p_b[..., 1] + 6.0 * p_b[..., 2])
            col_b = np.clip(base + swirl[..., None], 0.03, 0.97)
            color = np.where(hit[..., None], col_b, color)
            normal = np.where(hit[..., None], n_b, normal)
            t_best = np.where(hit, t_near, t_best)
        for c, r, base in self.spheres:
            oc = origins - c
            a = np.sum(d * d, axis=-1)
            b = 2 * np.sum(oc * d, axis=-1)
            cc = np.sum(oc * oc, axis=-1) - r * r
            disc = b * b - 4 * a * cc
            hit = disc > 0
            sq = np.sqrt(np.maximum(disc, 0))
            t_s = (-b - sq) / (2 * a)
            valid = hit & (t_s > 1e-4) & (t_s < t_best)
            p_s = origins + t_s[..., None] * d
            n_s = (p_s - c) / r
            col_s = self._sphere_color(base, p_s, np.asarray(c))
            color = np.where(valid[..., None], col_s, color)
            normal = np.where(valid[..., None], n_s, normal)
            t_best = np.where(valid, t_s, t_best)
        return color, t_best, normal


def look_at_c2w(pos: np.ndarray, target: np.ndarray, up=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """CV-convention camera-to-world (x right, y down, z forward)."""
    f = target - pos
    f = f / np.linalg.norm(f)
    x = np.cross(f, up)
    x = x / np.linalg.norm(x)
    y = np.cross(f, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, f, pos
    return c2w


def orbit_trajectory(scene: RoomScene, n_frames: int,
                     frames_per_rev: int = 900,
                     look_mult: float = 1.33) -> List[np.ndarray]:
    """Smooth interior orbit with *constant physical velocity* (~2 cm and
    <0.5 deg per frame at the default rate, like a handheld RGBD capture) —
    frame count only controls how much of the orbit is covered.

    ``look_mult`` decouples view rotation from orbital position (1.33
    default sweeps more of the room per lap).  Loop-closure probes set
    ``look_mult=1.0`` and a small ``frames_per_rev`` so laps genuinely
    REVISIT earlier views (same position AND same view direction) — with
    the 1.33 default the view at position-revisit differs by ~119 deg and
    no place-recognition gate can accept it."""
    center = (scene.lo + scene.hi) / 2
    poses = []
    for i in range(n_frames):
        s = i / frames_per_rev
        ang = 2 * np.pi * s
        pos = center + np.array([
            0.45 * np.cos(ang), 0.25 * np.sin(2 * ang) + 0.1, 0.45 * np.sin(ang),
        ])
        look_ang = 2 * np.pi * s * look_mult
        target = center + np.array([
            1.8 * np.cos(look_ang), 0.35 * np.sin(look_ang * 0.5), 1.8 * np.sin(look_ang),
        ])
        poses.append(look_at_c2w(pos, target))
    return poses


def render_rgbd(scene: RoomScene, c2w: np.ndarray, K: np.ndarray,
                H: int, W: int, depth_noise: float = 0.0,
                rng: np.random.Generator | None = None):
    """Exact RGBD render: z-depth (metres) like a real RGBD sensor."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    dirs_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, dtype=np.float64)], axis=-1)
    dirs_w = dirs_cam @ c2w[:3, :3].T
    origins = np.broadcast_to(c2w[:3, 3], dirs_w.shape)
    color, t, _ = scene.cast(origins, dirs_w)
    depth = t * dirs_cam[..., 2]  # z-depth: t scales the unit-z camera ray
    if depth_noise > 0:
        rng = rng or np.random.default_rng(0)
        depth = depth * (1.0 + depth_noise * rng.standard_normal(depth.shape))
    return color.astype(np.float32), depth.astype(np.float32)


def default_intrinsics(H: int, W: int) -> np.ndarray:
    fx = 0.85 * W
    return np.array([[fx, 0, W / 2 - 0.5], [0, fx, H / 2 - 0.5], [0, 0, 1.0]])


def make_cameras(n_frames: int = 20, H: int = 240, W: int = 320,
                 scene: RoomScene | None = None, depth_noise: float = 0.0,
                 frames_per_rev: int = 900,
                 look_mult: float = 1.33) -> List[Camera]:
    """In-memory synthetic sequence of Camera frames with gt poses."""
    scene = scene or RoomScene()
    K = default_intrinsics(H, W)
    cams = []
    raw_poses = orbit_trajectory(scene, n_frames, frames_per_rev, look_mult)
    # store first-frame-normalized poses (dataset readers do the same,
    # scene/dataset_readers.py:868-876) but render from the raw world pose
    first_inv = np.linalg.inv(raw_poses[0])
    for uid, raw_c2w in enumerate(raw_poses):
        color, depth = render_rgbd(scene, raw_c2w, K, H, W, depth_noise)
        c2w = first_inv @ raw_c2w
        w2c = np.linalg.inv(c2w)
        cams.append(Camera(
            uid=uid,
            R=np.transpose(w2c[:3, :3]),
            T=w2c[:3, 3],
            FoVx=focal2fov(K[0, 0], W),
            FoVy=focal2fov(K[1, 1], H),
            image=color,
            depth=depth[..., None],
            image_name=f"{uid}",
            cx=K[0, 2],
            cy=K[1, 2],
            timestamp=uid / 30.0,
            pose_gt=c2w,
        ))
    return cams
