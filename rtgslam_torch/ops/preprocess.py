"""Frame preprocessing: vertex / normal / confidence maps, the bilateral
depth filter and depth pyramids.

Port of ``rtgslam_tpu/ops/preprocess.py`` (reference ``SLAM/utils.py``:
vertex map :65, Sobel normals :100, confidence :125, bilateral filter
:550, pooling :655).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def transform_map(m: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 transform to an [H,W,3] map of points (of directions
    when the transform is rotation-only)."""
    return m @ transform[:3, :3].T + transform[:3, 3]


def _pixel_grid(H: int, W: int, like: torch.Tensor):
    u = torch.arange(W, dtype=like.dtype, device=like.device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=like.dtype, device=like.device)[:, None].expand(H, W)
    return u, v


def compute_vertex_map(depth: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Back-project an [H,W] or [H,W,1] depth map into camera-space points."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    H, W = depth.shape
    u, v = _pixel_grid(H, W, depth)
    dirs = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                        torch.ones_like(u)], dim=-1)
    return dirs * depth[..., None]


def _sobel(img: torch.Tensor):
    """Replicate-padded Sobel x/y gradients of an [H,W,C] map."""
    pad = F.pad(img.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")
    pad = pad[0].permute(1, 2, 0)
    smooth_y = pad[:-2] + 2 * pad[1:-1] + pad[2:]            # [H, W+2, C]
    dx = smooth_y[:, 2:] - smooth_y[:, :-2]
    smooth_x = pad[:, :-2] + 2 * pad[:, 1:-1] + pad[:, 2:]   # [H+2, W, C]
    dy = smooth_x[2:] - smooth_x[:-2]
    return dx, dy


def compute_normal_map(vertex_map: torch.Tensor) -> torch.Tensor:
    """normal = cross(dy, dx) normalized; pixels at the image's min (zeros)
    or max depth are zeroed."""
    dx, dy = _sobel(vertex_map)
    normal = torch.linalg.cross(dy, dx, dim=-1)
    normal = normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + 1e-8)
    depth = vertex_map[..., 2]
    invalid = (depth <= depth.min()) | (depth >= depth.max())
    return torch.where(invalid[..., None], 0.0, normal)


def compute_confidence_map(normal_map: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Per-pixel |cos| between the viewing ray and the normal, [H,W,1]."""
    H, W = normal_map.shape[:2]
    u, v = _pixel_grid(H, W, normal_map)
    ray = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                       torch.ones_like(u)], dim=-1)
    ray = ray / (torch.linalg.norm(ray, dim=-1, keepdim=True) + 1e-8)
    n = normal_map / (torch.linalg.norm(normal_map, dim=-1, keepdim=True) + 1e-8)
    return torch.abs(torch.sum(ray * n, dim=-1, keepdim=True))


def bilateral_filter(depth: torch.Tensor, radius: int = 5,
                     sigma_color: float = 2.0, sigma_space: float = 2.0) -> torch.Tensor:
    """Bilateral depth filter over a disc of ``radius``; zero-depth
    neighbours are excluded, zero-weight outputs stay zero (``:85``; as in
    the reference, a zero-depth centre is inpainted from valid neighbours)."""
    squeeze = depth.ndim == 3
    if squeeze:
        depth = depth[..., 0]
    H, W = depth.shape
    pad = F.pad(depth, (radius, radius, radius, radius))
    weight_sum = torch.zeros_like(depth)
    pixel_sum = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy * dy + dx * dx > radius * radius:
                continue
            shifted = pad[radius + dy:radius + dy + H, radius + dx:radius + dx + W]
            sw = -(dy * dy + dx * dx) / (2 * sigma_space ** 2)
            cw = -((depth - shifted) ** 2) / (2 * sigma_color ** 2)
            w = torch.exp(sw + cw) * (shifted != 0)
            weight_sum = weight_sum + w
            pixel_sum = pixel_sum + w * shifted
    out = torch.where(weight_sum == 0, 0.0,
                      pixel_sum / torch.clamp(weight_sum, min=1e-12))
    return out[..., None] if squeeze else out


def maxpool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Stride max-pool of an [H,W] map, zero-padded to a stride multiple."""
    H, W = x.shape
    x = F.pad(x, (0, (-W) % stride, 0, (-H) % stride))
    Hp, Wp = x.shape
    return x.reshape(Hp // stride, stride, Wp // stride, stride).amax(dim=(1, 3))


def depth_pyramid(depth: torch.Tensor, levels: int):
    """Coarse-to-fine max-pooled depth pyramid: level i is pooled by
    2**(levels-1-i), the last level is full resolution (``:136``)."""
    if depth.ndim == 3:
        depth = depth[..., 0]
    out = []
    for i in range(levels):
        k = 1 << (levels - 1 - i)
        out.append(depth if k == 1 else maxpool(depth, k))
    return out
