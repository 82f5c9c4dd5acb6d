"""Front-to-back alpha blending over per-tile depth-ordered lists.

Port of ``rtgslam_tpu/ops/rasterize/blend.py`` (inference mode).  Two
implementations of one function:

* :func:`blend_tiles` — the wrapper of kernel K1 (``csrc/blend_fwd.cu``),
  hand-written CUDA for Hopper.  It replaces the TPU kernel
  ``rtgslam_tpu/ops/rasterize/pallas_blend.py::_kernel`` (and the XLA
  ``blend_tiles`` it mirrors).  A CUDA tensor goes to the kernel or raises;
  only a CPU tensor takes the plain version.
* :func:`blend_tiles_reference` — the plain PyTorch twin: a per-chunk,
  all-tiles-at-once transcription of ``blend.py::_blend_chunk`` (:228) with
  the early-exit loop of :367-377.  Tests and ``chip_smoke.py`` hold K1
  against it.

Per-pixel outputs (contract of ``SLAM/render.py:110-133``): color, final T,
the depth / index / weight of the first eligible entry with alpha >=
opaque_threshold, and the index / weight of the largest-weight entry.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...utils.cuda_build import load_library
from .binning import TILE

CHUNK = 128
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
NFEAT = 11   # mean_x mean_y conic_a conic_b conic_c depth r g b opacity elig


class TileOutputs(NamedTuple):
    color: torch.Tensor         # [T, 256, 3]
    depth: torch.Tensor         # [T, 256]
    depth_index: torch.Tensor   # [T, 256] int32, -1 = none
    color_index: torch.Tensor   # [T, 256] int32, -1 = none
    depth_weight: torch.Tensor  # [T, 256]
    color_weight: torch.Tensor  # [T, 256]
    T_final: torch.Tensor       # [T, 256]


def tile_pixels(origins: torch.Tensor) -> torch.Tensor:
    """[T, 256, 2] pixel coordinates of each tile from its (x, y) origin
    (``blend.py::_tile_pixels``)."""
    r = torch.arange(TILE, dtype=torch.float32, device=origins.device)
    px = r.repeat(TILE)
    py = r.repeat_interleave(TILE)
    return torch.stack([px, py], dim=-1)[None] + origins[:, None, :]


def _check_inputs(feat, order, tile_lists, tile_counts, origins):
    V = order.shape[0]
    T, Kt = tile_lists.shape
    if feat.shape != (V + 1, NFEAT):
        raise ValueError(f"feat must be [V+1, {NFEAT}] = [{V + 1}, {NFEAT}], "
                         f"got {tuple(feat.shape)}")
    if tile_counts.shape != (T,) or origins.shape != (T, 2):
        raise ValueError("tile_counts must be [T] and origins [T, 2]")
    if Kt % min(CHUNK, Kt):
        raise ValueError("tile_capacity must be a multiple of 128 (or below)")
    for name, x, dt in (("feat", feat, torch.float32),
                        ("order", order, torch.int32),
                        ("tile_lists", tile_lists, torch.int32),
                        ("tile_counts", tile_counts, torch.int32),
                        ("origins", origins, torch.float32)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.device != feat.device:
            raise ValueError(f"{name} is on {x.device}, feat on {feat.device}")


_P = ctypes.c_void_p
_lib = None


def _kernel_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_library("blend_fwd")
        lib.rtg_blend_fwd.argtypes = [
            _P, _P, ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            _P, _P, _P, _P, _P, _P, _P, _P]
        lib.rtg_blend_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def blend_tiles(
    feat: torch.Tensor,         # [V+1, 11] depth-sorted rows, row V = zeros
    order: torch.Tensor,        # [V] int32 sorted position -> map slot
    tile_lists: torch.Tensor,   # [T, Kt] int32 sorted positions (sentinel V)
    tile_counts: torch.Tensor,  # [T] int32
    origins: torch.Tensor,      # [T, 2] float32 tile pixel origins
    opaque_threshold: float,
    T_threshold: float = 1e-4,
) -> TileOutputs:
    """Blend every tile (the JAX ``blend.blend_tiles`` call contract).

    CUDA tensors launch K1 on the current stream; CPU tensors run
    :func:`blend_tiles_reference`.  ``blend_tiles.launches`` counts kernel
    launches."""
    _check_inputs(feat, order, tile_lists, tile_counts, origins)
    if feat.device.type == "cpu":
        return blend_tiles_reference(feat, order, tile_lists, tile_counts,
                                     origins, opaque_threshold, T_threshold)
    if feat.device.type != "cuda":
        raise ValueError(f"blend_tiles runs on cuda or cpu, not {feat.device}")
    feat, order, tile_lists, tile_counts, origins = (
        x.contiguous() for x in (feat, order, tile_lists, tile_counts, origins))
    T, Kt = tile_lists.shape
    npx = TILE * TILE
    f32 = dict(dtype=torch.float32, device=feat.device)
    i32 = dict(dtype=torch.int32, device=feat.device)
    out = TileOutputs(
        color=torch.empty((T, npx, 3), **f32),
        depth=torch.empty((T, npx), **f32),
        depth_index=torch.empty((T, npx), **i32),
        color_index=torch.empty((T, npx), **i32),
        depth_weight=torch.empty((T, npx), **f32),
        color_weight=torch.empty((T, npx), **f32),
        T_final=torch.empty((T, npx), **f32),
    )
    lib = _kernel_lib()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.rtg_blend_fwd(
            feat.data_ptr(), order.data_ptr(), order.shape[0],
            tile_lists.data_ptr(), tile_counts.data_ptr(), origins.data_ptr(),
            T, Kt, float(opaque_threshold), float(T_threshold),
            *(x.data_ptr() for x in out), stream)
    if rc != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {rc}")
    blend_tiles.launches += 1
    return out


blend_tiles.launches = 0


def blend_tiles_reference(feat, order, tile_lists, tile_counts, origins,
                          opaque_threshold, T_threshold=1e-4) -> TileOutputs:
    """Plain PyTorch twin of :func:`blend_tiles` (same arguments).

    Chunk by chunk over all still-active tiles at once: a tile takes chunk
    ``c`` while ``c`` is below its chunk count and its max T exceeds
    ``T_threshold``.  Transmittance is the JAX log-space exclusive product,
    ``exp(excl_cumsum(log1p(-alpha)))``."""
    device = feat.device
    T_tiles, Kt = tile_lists.shape
    npx = TILE * TILE
    chunk = min(CHUNK, Kt)
    lists = tile_lists.long()
    order_pad = torch.cat([order, order.new_full((1,), -1)])
    tile_feat = feat[lists]                           # [T, Kt, 11]
    tile_gidx = order_pad[lists]                      # [T, Kt]
    pix = tile_pixels(origins)                        # [T, 256, 2]
    n_chunks = (tile_counts.long() + chunk - 1) // chunk
    tri = torch.triu(torch.ones(chunk, chunk, device=device), diagonal=1)

    Tm = torch.ones((T_tiles, npx), device=device)
    color = torch.zeros((T_tiles, npx, 3), device=device)
    depth = torch.zeros((T_tiles, npx), device=device)
    didx = torch.full((T_tiles, npx), -1, dtype=torch.int32, device=device)
    dw = torch.zeros((T_tiles, npx), device=device)
    cidx = torch.full((T_tiles, npx), -1, dtype=torch.int32, device=device)
    cw = torch.zeros((T_tiles, npx), device=device)

    for c in range(Kt // chunk):
        active = (c < n_chunks) & (Tm.amax(dim=1) > T_threshold)
        a = torch.nonzero(active).squeeze(1)
        if a.numel() == 0:
            break
        f = tile_feat[a, c * chunk:(c + 1) * chunk]   # [A, C, 11]
        g = tile_gidx[a, c * chunk:(c + 1) * chunk]   # [A, C]
        dx = pix[a, :, 0, None] - f[:, None, :, 0]    # [A, 256, C]
        dy = pix[a, :, 1, None] - f[:, None, :, 1]
        power = -0.5 * (f[:, None, :, 2] * dx * dx
                        + f[:, None, :, 4] * dy * dy) \
            - f[:, None, :, 3] * dx * dy
        alpha = f[:, None, :, 9] * torch.exp(torch.clamp(power, max=0.0))
        alpha = torch.where(power > 0, 0.0, alpha)
        alpha = torch.clamp(alpha, max=ALPHA_MAX)
        alpha = torch.where(alpha < ALPHA_EPS, 0.0, alpha)
        opaque = (f[:, None, :, 10] > 0.5) & (alpha >= opaque_threshold)

        excl = torch.exp(torch.log1p(-alpha) @ tri)   # exclusive product
        T_a = Tm[a]
        w = alpha * (T_a[:, :, None] * excl)          # [A, 256, C]
        color[a] = color[a] + w @ f[:, :, 6:9]

        has_hit = opaque.any(dim=2)
        first = torch.argmax(opaque.to(torch.uint8), dim=2, keepdim=True)
        new_hit = has_hit & (didx[a] < 0)
        zc = f[:, :, 5][:, None, :].expand(-1, npx, -1)
        gc = g[:, None, :].expand(-1, npx, -1)
        depth[a] = torch.where(new_hit, zc.gather(2, first)[..., 0], depth[a])
        didx[a] = torch.where(new_hit, gc.gather(2, first)[..., 0], didx[a])
        dw[a] = torch.where(new_hit, w.gather(2, first)[..., 0], dw[a])

        best = torch.argmax(w, dim=2, keepdim=True)   # first maximum
        best_w = w.gather(2, best)[..., 0]
        better = best_w > cw[a]
        cw[a] = torch.where(better, best_w, cw[a])
        cidx[a] = torch.where(better, gc.gather(2, best)[..., 0], cidx[a])

        Tm[a] = T_a * excl[..., -1] * (1.0 - alpha[..., -1])

    return TileOutputs(color=color, depth=depth, depth_index=didx,
                       color_index=cidx, depth_weight=dw, color_weight=cw,
                       T_final=Tm)
