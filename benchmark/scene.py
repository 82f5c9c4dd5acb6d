"""The benchmark's input sequences: the procedural room, ray-cast on the device.

A PyTorch copy of the port's ``data/synthetic.py`` room (its walls,
furniture boxes, spheres and textures, the exact ray caster and the
``orbit_trajectory`` camera path), so the frames of a run are made on the
card in a few large calls.  The traffic file fixes them: the sensor
(intrinsics, depth step, the noise model and the seed of its draw) and the
motion (``frames_per_rev``, ``look_mult``, the orbit's start), so every run
of a cell sees the same frames and does the same work.

Frames come back to the host as a decoder would deliver them: colour
quantised to 8 bits, depth to the sensor's step (``1 / depth_scale``
metres), both as float32 numpy arrays, so the tracker's upload stays in the
timed path.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

ROOM_LO = (0.0, 0.0, 0.0)
ROOM_HI = (4.0, 3.0, 4.0)
# (centre, radius, base rgb)
SPHERES = (
    ((1.2, 1.0, 1.4), 0.45, (0.85, 0.35, 0.25)),
    ((2.9, 0.8, 2.8), 0.35, (0.25, 0.65, 0.85)),
    ((2.0, 2.2, 1.0), 0.30, (0.40, 0.80, 0.35)),
    ((0.7, 2.1, 2.9), 0.40, (0.80, 0.70, 0.30)),
    ((3.3, 1.9, 1.2), 0.35, (0.55, 0.40, 0.80)),
    ((1.0, 0.6, 3.2), 0.30, (0.30, 0.75, 0.70)),
    ((3.1, 0.9, 0.8), 0.40, (0.85, 0.50, 0.60)),
    ((0.6, 1.2, 0.7), 0.35, (0.45, 0.60, 0.85)),
    ((2.2, 2.4, 3.1), 0.30, (0.70, 0.80, 0.45)),
    ((1.7, 0.5, 2.2), 0.25, (0.90, 0.65, 0.35)),
    ((3.2, 2.0, 2.6), 0.22, (0.35, 0.55, 0.75)),
    ((0.8, 2.4, 1.2), 0.26, (0.65, 0.45, 0.55)),
    ((2.55, 1.95, 3.72), 0.26, (0.75, 0.55, 0.40)),
    ((3.74, 1.85, 2.50), 0.24, (0.40, 0.70, 0.60)),
)
# (lo, hi, base rgb)
BOXES = (
    ((0.0, 0.0, 0.0), (0.9, 0.8, 1.1), (0.75, 0.55, 0.35)),
    ((3.1, 0.0, 2.9), (4.0, 1.3, 4.0), (0.35, 0.6, 0.5)),
    ((1.6, 0.0, 3.4), (2.6, 0.6, 4.0), (0.55, 0.45, 0.7)),
    ((0.0, 1.6, 1.6), (0.5, 2.4, 2.6), (0.65, 0.6, 0.3)),
    ((3.5, 1.4, 0.0), (4.0, 2.2, 0.9), (0.5, 0.65, 0.75)),
    ((1.3, 2.5, 0.0), (2.5, 3.0, 0.5), (0.7, 0.4, 0.45)),
    ((0.0, 0.0, 2.4), (0.6, 0.5, 3.2), (0.45, 0.7, 0.4)),
    ((2.9, 2.4, 1.5), (4.0, 3.0, 2.3), (0.6, 0.5, 0.65)),
    ((1.80, 1.45, 3.70), (2.25, 1.80, 4.0), (0.55, 0.65, 0.45)),
    ((3.70, 1.25, 1.75), (4.0, 1.65, 2.20), (0.70, 0.50, 0.55)),
)
# rays per ray-casting call: bounds the caster's float64 temporaries
RAYS_PER_CALL = 1 << 22


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx[..., None])[..., 0]


def _wall_color(wall_id, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    wid = wall_id.to(p.dtype)
    u = torch.where(wall_id // 2 == 0, z, x)
    v = torch.where(wall_id // 2 == 1, z, y)
    base = torch.stack([
        0.55 + 0.18 * torch.sin(2.1 * u + 0.7 * wid),
        0.50 + 0.18 * torch.sin(1.7 * v + 1.9 * wid),
        0.45 + 0.18 * torch.sin(1.3 * (u + v) + 3.1 * wid),
    ], dim=-1)
    detail = 0.08 * torch.sin(9.0 * u)[..., None] * torch.cos(7.0 * v)[..., None]
    return torch.clamp(base + detail, 0.03, 0.97)


def _axis_normal(axis, sign, like):
    n = torch.zeros_like(like)
    n.scatter_(-1, axis[..., None], sign[..., None])
    return n


def cast(origins: torch.Tensor, dirs: torch.Tensor):
    """Exact nearest hit of rays against the room's walls, boxes and
    spheres (``RoomScene.cast``).  origins, dirs [..., 3] (world, not
    necessarily unit).  Returns (colour [..., 3], ray parameter t [...],
    normal [..., 3])."""
    dev, dt = dirs.device, dirs.dtype
    lo = torch.tensor(ROOM_LO, dtype=dt, device=dev)
    hi = torch.tensor(ROOM_HI, dtype=dt, device=dev)
    d = dirs
    safe_d = torch.where(torch.abs(d) < 1e-9, torch.full_like(d, 1e-9), d)
    t_axis = torch.where(d > 0, (hi - origins) / safe_d, (lo - origins) / safe_d)
    axis = torch.argmin(t_axis, dim=-1)
    t_best = _take(t_axis, axis)
    d_axis = _take(d, axis)
    wall_id = 2 * axis + (d_axis > 0).to(torch.int64)
    color = _wall_color(wall_id, origins + t_best[..., None] * d)
    one = torch.ones_like(d_axis)
    normal = _axis_normal(axis, torch.where(d_axis > 0, -one, one), d)

    for blo, bhi, base in BOXES:
        blo_t = torch.tensor(blo, dtype=dt, device=dev)
        bhi_t = torch.tensor(bhi, dtype=dt, device=dev)
        t1 = (blo_t - origins) / safe_d
        t2 = (bhi_t - origins) / safe_d
        t_near = torch.amax(torch.minimum(t1, t2), dim=-1)
        t_far = torch.amin(torch.maximum(t1, t2), dim=-1)
        hit = (t_near < t_far) & (t_near > 1e-4) & (t_near < t_best)
        p_b = origins + t_near[..., None] * d
        axis_b = torch.argmax(torch.minimum(t1, t2), dim=-1)
        d_axis_b = _take(d, axis_b)
        n_b = _axis_normal(axis_b, torch.where(d_axis_b > 0, -one, one), d)
        swirl = 0.1 * torch.sin(5.0 * p_b[..., 0] + 4.0 * p_b[..., 1]
                                + 6.0 * p_b[..., 2])
        col_b = torch.clamp(torch.tensor(base, dtype=dt, device=dev)
                            + swirl[..., None], 0.03, 0.97)
        color = torch.where(hit[..., None], col_b, color)
        normal = torch.where(hit[..., None], n_b, normal)
        t_best = torch.where(hit, t_near, t_best)

    for c, r, base in SPHERES:
        c_t = torch.tensor(c, dtype=dt, device=dev)
        oc = origins - c_t
        a = torch.sum(d * d, dim=-1)
        b = 2 * torch.sum(oc * d, dim=-1)
        cc = torch.sum(oc * oc, dim=-1) - r * r
        disc = b * b - 4 * a * cc
        sq = torch.sqrt(torch.clamp(disc, min=0))
        t_s = (-b - sq) / (2 * a)
        valid = (disc > 0) & (t_s > 1e-4) & (t_s < t_best)
        p_s = origins + t_s[..., None] * d
        n_s = (p_s - c_t) / r
        local = p_s - c_t
        swirl = 0.12 * torch.sin(8.0 * local[..., 0] + 6.0 * local[..., 1])
        col_s = torch.clamp(torch.tensor(base, dtype=dt, device=dev)
                            + swirl[..., None], 0.03, 0.97)
        color = torch.where(valid[..., None], col_s, color)
        normal = torch.where(valid[..., None], n_s, normal)
        t_best = torch.where(valid, t_s, t_best)
    return color, t_best, normal


def look_at_c2w(pos: np.ndarray, target: np.ndarray,
                up=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """CV-convention camera-to-world (x right, y down, z forward)."""
    f = target - pos
    f = f / np.linalg.norm(f)
    x = np.cross(f, up)
    x = x / np.linalg.norm(x)
    y = np.cross(f, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, f, pos
    return c2w


def orbit_trajectory(n_frames: int, frames_per_rev: float, look_mult: float,
                     phase: float = 0.0) -> List[np.ndarray]:
    """The room's interior orbit (``orbit_trajectory``), started ``phase``
    revolutions along: world camera-to-world poses [4, 4], float64."""
    center = (np.array(ROOM_LO) + np.array(ROOM_HI)) / 2
    poses = []
    for i in range(n_frames):
        s = phase + i / frames_per_rev
        ang = 2 * np.pi * s
        pos = center + np.array([
            0.45 * np.cos(ang), 0.25 * np.sin(2 * ang) + 0.1, 0.45 * np.sin(ang)])
        look_ang = 2 * np.pi * s * look_mult
        target = center + np.array([
            1.8 * np.cos(look_ang), 0.35 * np.sin(look_ang * 0.5),
            1.8 * np.sin(look_ang)])
        poses.append(look_at_c2w(pos, target))
    return poses


def intrinsics(sensor: Dict) -> np.ndarray:
    return np.array([[sensor["fx"], 0.0, sensor["cx"]],
                     [0.0, sensor["fy"], sensor["cy"]],
                     [0.0, 0.0, 1.0]])


def render_rgbd(c2w: torch.Tensor, K: np.ndarray, H: int, W: int) -> tuple:
    """Exact colour [H, W, 3] and z-depth [H, W] of one pose (float64
    tensors on ``c2w``'s device)."""
    dev, dt = c2w.device, c2w.dtype
    v, u = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                          torch.arange(W, dtype=dt, device=dev), indexing="ij")
    dirs_cam = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                            torch.ones_like(u)], dim=-1)
    dirs_w = dirs_cam @ c2w[:3, :3].T
    origins = c2w[:3, 3].expand_as(dirs_w)
    colour = torch.empty((H * W, 3), dtype=dt, device=dev)
    depth = torch.empty((H * W,), dtype=dt, device=dev)
    flat_o, flat_d = origins.reshape(-1, 3), dirs_w.reshape(-1, 3)
    for s in range(0, H * W, RAYS_PER_CALL):
        c, t, _ = cast(flat_o[s:s + RAYS_PER_CALL], flat_d[s:s + RAYS_PER_CALL])
        colour[s:s + RAYS_PER_CALL] = c
        depth[s:s + RAYS_PER_CALL] = t
    # z-depth: t scales the unit-z camera ray
    return colour.reshape(H, W, 3), depth.reshape(H, W)


def make_sequence(sensor: Dict, motion: Dict, H: int, W: int, n_frames: int,
                  device) -> Dict:
    """Ray-cast ``n_frames`` frames of the orbit on ``device`` and bring them
    to the host quantised.  ``sensor``: fx, fy, cx, cy, depth_scale (sensor
    units per metre), depth_noise_k (sigma_z = k z^2 metres; 0 or absent
    for none) and noise_seed; ``motion``: frames_per_rev, look_mult and
    start_phase (revolutions).  Returns colour [N] uint8-valued float32
    [H, W, 3], depth [N] float32 [H, W, 1], the first-frame normalised
    ground-truth poses [N, 4, 4] float64, K [3, 3] and the start phase."""
    K = intrinsics(sensor)
    phase = float(motion.get("start_phase", 0.0))
    raw = orbit_trajectory(n_frames, motion["frames_per_rev"],
                           motion["look_mult"], phase)
    first_inv = np.linalg.inv(raw[0])
    gen = torch.Generator(device=device).manual_seed(int(sensor.get("noise_seed", 0)))
    scale = float(sensor["depth_scale"])
    noise_k = float(sensor.get("depth_noise_k", 0.0))
    colours, depths = [], []
    for c2w in raw:
        colour, depth = render_rgbd(
            torch.as_tensor(c2w, dtype=torch.float64, device=device), K, H, W)
        if noise_k > 0:
            depth = depth + noise_k * depth * depth * torch.randn(
                depth.shape, generator=gen, dtype=depth.dtype, device=device)
        c8 = torch.round(colour * 255.0).to(torch.float32) / 255.0
        dq = torch.round(depth * scale).clamp(0, 65535).to(torch.float32) / scale
        colours.append(c8)
        depths.append(dq[..., None])
    colour_host = torch.stack(colours).cpu().numpy()
    depth_host = torch.stack(depths).cpu().numpy()
    return {"colour": list(colour_host), "depth": list(depth_host),
            "poses": np.stack([first_inv @ p for p in raw]), "K": K,
            "phase": phase, "depth_scale": scale}


def fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))
