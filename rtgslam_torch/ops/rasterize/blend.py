"""Front-to-back alpha blending over per-tile depth-ordered lists, and its
backward.

Port of ``rtgslam_tpu/ops/rasterize/blend.py``.  Each function comes twice:

* a wrapper of a hand-written CUDA kernel for Hopper — :func:`blend_tiles`
  (kernel K1, ``csrc/blend_fwd.cu``; inference and residual modes),
  :func:`blend_transmission` (K1's transmission mode),
  :func:`blend_bwd_partials` (kernel K2, ``csrc/blend_bwd.cu``: per tile-list
  position gradients) and :func:`blend_bwd_reduce` (the same source's
  reduce kernel: their fixed-order sum per feature row, through the CSR
  inverse index of :func:`row_index`); :func:`blend_bwd` is K2 then the
  reduce.  K1 replaces the TPU kernel ``pallas_blend.py::_kernel``, K2 with
  the reduce ``pallas_blend.py::_bwd_kernel``.  A CUDA tensor goes to the
  kernel or raises; only a CPU tensor takes the plain version;
* its plain PyTorch twin — :func:`blend_tiles_reference`,
  :func:`blend_transmission_reference`, :func:`blend_bwd_partials_reference`,
  :func:`blend_bwd_reduce_reference` (and :func:`blend_bwd_reference`, the
  two chained): per-chunk, all-tiles-at-once transcriptions of the JAX
  ``_blend_chunk`` (:228) with the early-exit loop of :367-377, of
  ``blend_transmission`` (:482) and of ``_fused_bwd`` (:726).  Tests and
  ``chip_smoke.py`` hold the kernels against them.

:class:`BlendFunction` is the differentiable blend of the optimize loop
(``blend_tiles_fused`` :653): K1 in residual mode forward, K2 backward.

Per-pixel outputs (contract of ``SLAM/render.py:110-133``): color, final T,
the depth / index / weight of the first eligible entry with alpha >=
opaque_threshold, and the index / weight of the largest-weight entry.

``launches`` counts kernel launches per kernel mode; nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from ...utils.cuda_build import load_library
from .binning import TILE

CHUNK = 128
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
NFEAT = 11   # mean_x mean_y conic_a conic_b conic_c depth r g b opacity elig
NTRANS = 6   # mean_x mean_y conic_a conic_b conic_c opacity
NPIX = TILE * TILE

launches = {"blend_fwd": 0, "blend_fwd_residual": 0,
            "blend_fwd_transmission": 0, "blend_bwd": 0,
            "blend_bwd_reduce": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class RowIndex(NamedTuple):
    """CSR inverse index of a set of tile lists (:func:`row_index`)."""
    row_ptr: torch.Tensor   # [V+2] int32: row r's positions are pos[row_ptr[r]:row_ptr[r+1]]
    pos: torch.Tensor       # [T*Kt] int32 positions t*Kt + k, by row, ascending


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
    r = torch.arange(TILE, dtype=origins.dtype, device=origins.device)
    px = r.repeat(TILE)
    py = r.repeat_interleave(TILE)
    return torch.stack([px, py], dim=-1)[None] + origins[:, None, :]


def _check(feat, ncols: int, tile_lists, origins, ints=()):
    """Shapes, dtypes and devices shared by every blend entry point.  The
    kernels take float32; the plain twins also take float64 on the CPU (the
    gradient check)."""
    T, Kt = tile_lists.shape
    if feat.ndim != 2 or feat.shape[1] != ncols:
        raise ValueError(f"feature rows must be [V+1, {ncols}], got "
                         f"{tuple(feat.shape)}")
    if origins.shape != (T, 2):
        raise ValueError("origins must be [T, 2]")
    if Kt % min(CHUNK, Kt):
        raise ValueError("tile_capacity must be a multiple of 128 (or below)")
    fdt = feat.dtype
    if fdt != torch.float32 and not (fdt == torch.float64
                                     and feat.device.type == "cpu"):
        raise TypeError(f"feature rows must be float32, got {fdt}")
    for name, x, dt in (("origins", origins, fdt),
                        ("tile_lists", tile_lists, torch.int32),
                        *((n, x, torch.int32) for n, x in ints)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if x.device != feat.device:
            raise ValueError(f"{name} is on {x.device}, feat on {feat.device}")
    if feat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the blend runs on cuda or cpu, not {feat.device}")


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_libs = {}


def _kernel_lib(name: str = "blend_fwd") -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/<name>.cu``."""
    if name not in _libs:
        lib = load_library(name)
        if name == "blend_fwd":
            lib.rtg_blend_fwd.argtypes = [
                _P, _P, _I, _P, _P, _P, _I, _I, _F, _F] + [_P] * 8
            lib.rtg_blend_fwd_residual.argtypes = [
                _P, _P, _I, _P, _P, _P, _I, _I, _F, _F] + [_P] * 11
            lib.rtg_blend_transmission.argtypes = [
                _P, _I, _P, _P, _P, _I, _I, _F, _P, _P]
            for fn in (lib.rtg_blend_fwd, lib.rtg_blend_fwd_residual,
                       lib.rtg_blend_transmission):
                fn.restype = _I
        else:
            lib.rtg_blend_bwd.argtypes = [
                _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                _P, _P]
            lib.rtg_blend_bwd_reduce.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P]
            for fn in (lib.rtg_blend_bwd, lib.rtg_blend_bwd_reduce):
                fn.restype = _I
        _libs[name] = lib
    return _libs[name]


def _launch(fn, kernel: str, *args) -> None:
    """Launch on the current stream (the calling thread's); raise on a
    refused launch."""
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {rc}")
    _count(kernel)


def _count(kernel: str) -> None:
    with _launch_lock:   # the pipelined system's threads both count here
        launches[kernel] += 1


def _ptrs(*xs):
    return tuple(x.data_ptr() for x in xs)


# ---------------------------------------------------------------------------
# forward blend: K1 inference / residual modes
# ---------------------------------------------------------------------------

def blend_tiles(
    feat: torch.Tensor,         # [V+1, 11] depth-sorted rows, row V = zeros
    order: torch.Tensor,        # [V] int32 sorted position -> index map value
    tile_lists: torch.Tensor,   # [T, Kt] int32 sorted positions (sentinel V)
    tile_counts: torch.Tensor,  # [T] int32
    origins: torch.Tensor,      # [T, 2] float32 tile pixel origins
    opaque_threshold: float,
    T_threshold: float = 1e-4,
    residuals: bool = False,
):
    """Blend every tile (the JAX ``blend.blend_tiles`` call contract).

    With ``residuals`` also returns what the backward replays, as
    ``(TileOutputs, entry [T, Kt/chunk, 256], done [T] int32, chunk_color
    [T, Kt/chunk, 256, 3])``: each chunk's entry transmittance, the number of
    chunks processed — the contract of ``_fused_fwd`` (:669-716) — and each
    chunk's sum of alpha T rgb per pixel, which spares the backward a sweep.
    For chunks the tile never reached, entry is 0 and chunk_color undefined
    (the backward never reads it; the plain twin leaves 0).

    List positions at and past a tile's count must hold the sentinel V, as
    binning leaves them: the kernel stops its walk at the count.

    CUDA tensors launch K1 on the current stream; CPU tensors run
    :func:`blend_tiles_reference`."""
    _check(feat, NFEAT, tile_lists, origins,
           (("order", order), ("tile_counts", tile_counts)))
    T, Kt = tile_lists.shape
    if order.shape[0] != feat.shape[0] - 1 or tile_counts.shape != (T,):
        raise ValueError("order must be [V] and tile_counts [T]")
    if feat.device.type == "cpu":
        return blend_tiles_reference(feat, order, tile_lists, tile_counts,
                                     origins, opaque_threshold, T_threshold,
                                     residuals)
    feat, order, tile_lists, tile_counts, origins = (
        x.contiguous() for x in (feat, order, tile_lists, tile_counts, origins))
    f32 = dict(dtype=torch.float32, device=feat.device)
    i32 = dict(dtype=torch.int32, device=feat.device)
    out = TileOutputs(
        color=torch.empty((T, NPIX, 3), **f32),
        depth=torch.empty((T, NPIX), **f32),
        depth_index=torch.empty((T, NPIX), **i32),
        color_index=torch.empty((T, NPIX), **i32),
        depth_weight=torch.empty((T, NPIX), **f32),
        color_weight=torch.empty((T, NPIX), **f32),
        T_final=torch.empty((T, NPIX), **f32),
    )
    lib = _kernel_lib()
    head = (*_ptrs(feat, order), order.shape[0],
            *_ptrs(tile_lists, tile_counts, origins), T, Kt,
            float(opaque_threshold), float(T_threshold), *_ptrs(*out))
    with torch.cuda.device(feat.device):
        if not residuals:
            if T:
                _launch(lib.rtg_blend_fwd, "blend_fwd", *head)
            return out
        entry = torch.empty((T, Kt // min(CHUNK, Kt), NPIX), **f32)
        done = torch.empty((T,), **i32)
        chunk_color = torch.empty(entry.shape + (3,), **f32)
        if T:
            _launch(lib.rtg_blend_fwd_residual, "blend_fwd_residual", *head,
                    *_ptrs(entry, done, chunk_color))
    return out, entry, done, chunk_color


def blend_tiles_reference(feat, order, tile_lists, tile_counts, origins,
                          opaque_threshold, T_threshold=1e-4,
                          residuals=False):
    """Plain PyTorch twin of :func:`blend_tiles` (same arguments).

    Chunk by chunk over all still-active tiles at once: a tile takes chunk
    ``c`` while ``c`` is below its chunk count and its max T exceeds
    ``T_threshold``.  Transmittance is the JAX log-space exclusive product,
    ``exp(excl_cumsum(log1p(-alpha)))``."""
    device, dt = feat.device, feat.dtype
    T_tiles, Kt = tile_lists.shape
    chunk = min(CHUNK, Kt)
    lists = tile_lists.long()
    order_pad = torch.cat([order, order.new_full((1,), -1)])
    tile_feat = feat[lists]                           # [T, Kt, 11]
    tile_gidx = order_pad[lists]                      # [T, Kt]
    pix = tile_pixels(origins)                        # [T, 256, 2]
    n_chunks = (tile_counts.long() + chunk - 1) // chunk
    tri = torch.triu(torch.ones(chunk, chunk, dtype=dt, device=device),
                     diagonal=1)

    Tm = torch.ones((T_tiles, NPIX), dtype=dt, device=device)
    color = torch.zeros((T_tiles, NPIX, 3), dtype=dt, device=device)
    depth = torch.zeros((T_tiles, NPIX), dtype=dt, device=device)
    didx = torch.full((T_tiles, NPIX), -1, dtype=torch.int32, device=device)
    dw = torch.zeros((T_tiles, NPIX), dtype=dt, device=device)
    cidx = torch.full((T_tiles, NPIX), -1, dtype=torch.int32, device=device)
    cw = torch.zeros((T_tiles, NPIX), dtype=dt, device=device)
    entry = torch.zeros((T_tiles, Kt // chunk, NPIX), dtype=dt, device=device)
    done = torch.zeros((T_tiles,), dtype=torch.int32, device=device)
    chunk_color = torch.zeros(entry.shape + (3,), dtype=dt, device=device)

    for c in range(Kt // chunk):
        active = (c < n_chunks) & (Tm.amax(dim=1) > T_threshold)
        a = torch.nonzero(active).squeeze(1)
        if a.numel() == 0:
            break
        entry[a, c] = Tm[a]
        done[a] += 1
        f = tile_feat[a, c * chunk:(c + 1) * chunk]   # [A, C, 11]
        g = tile_gidx[a, c * chunk:(c + 1) * chunk]   # [A, C]
        alpha, _, _, _, _ = _chunk_alphas(f, pix[a])
        opaque = (f[:, None, :, 10] > 0.5) & (alpha >= opaque_threshold)

        excl = torch.exp(torch.log1p(-alpha) @ tri)   # exclusive product
        T_a = Tm[a]
        w = alpha * (T_a[:, :, None] * excl)          # [A, 256, C]
        chunk_color[a, c] = w @ f[:, :, 6:9]
        color[a] = color[a] + chunk_color[a, c]

        has_hit = opaque.any(dim=2)
        first = torch.argmax(opaque.to(torch.uint8), dim=2, keepdim=True)
        new_hit = has_hit & (didx[a] < 0)
        zc = f[:, :, 5][:, None, :].expand(-1, NPIX, -1)
        gc = g[:, None, :].expand(-1, NPIX, -1)
        depth[a] = torch.where(new_hit, zc.gather(2, first)[..., 0], depth[a])
        didx[a] = torch.where(new_hit, gc.gather(2, first)[..., 0], didx[a])
        dw[a] = torch.where(new_hit, w.gather(2, first)[..., 0], dw[a])

        best = torch.argmax(w, dim=2, keepdim=True)   # first maximum
        best_w = w.gather(2, best)[..., 0]
        better = best_w > cw[a]
        cw[a] = torch.where(better, best_w, cw[a])
        cidx[a] = torch.where(better, gc.gather(2, best)[..., 0], cidx[a])

        Tm[a] = T_a * excl[..., -1] * (1.0 - alpha[..., -1])

    out = TileOutputs(color=color, depth=depth, depth_index=didx,
                      color_index=cidx, depth_weight=dw, color_weight=cw,
                      T_final=Tm)
    return (out, entry, done, chunk_color) if residuals else out


def _chunk_alphas(f, pix):
    """alpha of one chunk's entries ``f`` [A, C, >=10 or 6 cols] at the
    tiles' pixels ``pix`` [A, 256, 2] (``_chunk_alphas_vjp`` :609).
    Returns (alpha, exp term, gradient gate, dx, dy), each [A, 256, C]."""
    opa = f[:, None, :, 9] if f.shape[-1] == NFEAT else f[:, None, :, 5]
    dx = pix[:, :, 0, None] - f[:, None, :, 0]
    dy = pix[:, :, 1, None] - f[:, None, :, 1]
    power = -0.5 * (f[:, None, :, 2] * dx * dx + f[:, None, :, 4] * dy * dy) \
        - f[:, None, :, 3] * dx * dy
    e = torch.exp(torch.clamp(power, max=0.0))
    raw = opa * e
    gate = (power <= 0) & (raw >= ALPHA_EPS) & (raw < ALPHA_MAX)
    alpha = torch.where((power > 0) | (raw < ALPHA_EPS), 0.0,
                        torch.clamp(raw, max=ALPHA_MAX))
    return alpha, e, gate, dx, dy


# ---------------------------------------------------------------------------
# transmission only: K1 transmission mode
# ---------------------------------------------------------------------------

def blend_transmission(
    cols: torch.Tensor,         # [V+1, 6] depth-sorted rows, row V = zeros
    tile_lists: torch.Tensor,   # [T, Kt] int32 sorted positions (sentinel V)
    tile_counts: torch.Tensor,  # [T] int32
    origins: torch.Tensor,      # [T, 2] float32
    T_threshold: float = 1e-4,
) -> torch.Tensor:
    """Per-pixel final transmittance only, [T, 256] (``blend_transmission``
    :482): the optimize masks' render.  Rows hold mean_x, mean_y, conic
    a/b/c and opacity.  ``T != 1`` is exact on both paths: T is 1 iff every
    alpha of the pixel is 0."""
    _check(cols, NTRANS, tile_lists, origins, (("tile_counts", tile_counts),))
    T, Kt = tile_lists.shape
    if tile_counts.shape != (T,):
        raise ValueError("tile_counts must be [T]")
    if cols.device.type == "cpu":
        return blend_transmission_reference(cols, tile_lists, tile_counts,
                                            origins, T_threshold)
    cols, tile_lists, tile_counts, origins = (
        x.contiguous() for x in (cols, tile_lists, tile_counts, origins))
    out = torch.empty((T, NPIX), dtype=torch.float32, device=cols.device)
    with torch.cuda.device(cols.device):
        if T:
            _launch(_kernel_lib().rtg_blend_transmission,
                    "blend_fwd_transmission", cols.data_ptr(),
                    cols.shape[0] - 1, *_ptrs(tile_lists, tile_counts, origins),
                    T, Kt, float(T_threshold), out.data_ptr())
    return out


def blend_transmission_reference(cols, tile_lists, tile_counts, origins,
                                 T_threshold=1e-4):
    """Plain PyTorch twin of :func:`blend_transmission`: the JAX per-chunk
    log-space product ``T * exp(sum(log1p(-alpha)))`` (:527)."""
    T_tiles, Kt = tile_lists.shape
    chunk = min(CHUNK, Kt)
    tile_cols = cols[tile_lists.long()]              # [T, Kt, 6]
    pix = tile_pixels(origins)
    n_chunks = (tile_counts.long() + chunk - 1) // chunk
    Tm = torch.ones((T_tiles, NPIX), dtype=cols.dtype, device=cols.device)
    for c in range(Kt // chunk):
        active = (c < n_chunks) & (Tm.amax(dim=1) > T_threshold)
        a = torch.nonzero(active).squeeze(1)
        if a.numel() == 0:
            break
        alpha = _chunk_alphas(tile_cols[a, c * chunk:(c + 1) * chunk],
                              pix[a])[0]
        Tm[a] = Tm[a] * torch.exp(torch.sum(torch.log1p(-alpha), dim=2))
    return Tm


# ---------------------------------------------------------------------------
# backward blend: K2 and its reduce
# ---------------------------------------------------------------------------

NGRAD = 10   # gradient columns K2 writes: every column but elig
REDUCE_LANES = 16   # lanes per feature row in the reduce kernel


def row_index(tile_lists: torch.Tensor, tile_counts: torch.Tensor,
              n_rows: int) -> RowIndex:
    """The CSR inverse index of ``tile_lists`` [T, Kt] over the feature rows
    ``0..n_rows-1`` (``n_rows`` = V): a stable sort of the flattened lists,
    so each row's positions ``t*Kt + k`` come in ascending (tile, position)
    order.  Positions at or past their tile's count, sentinel entries and
    out-of-contract entries all sort into the sentinel row V's segment,
    which no row reads.  Built once per set of lists: the compact optimize
    loop freezes its lists for a whole call.  No host synchronization: the
    row pointers are a search of the sorted keys."""
    T, Kt = tile_lists.shape
    k = torch.arange(Kt, dtype=torch.int32, device=tile_lists.device)
    keys = torch.where(k[None, :] < tile_counts[:, None], tile_lists,
                       n_rows).reshape(-1)
    keys = torch.where((keys < 0) | (keys > n_rows), n_rows, keys)
    sorted_keys, pos = torch.sort(keys, stable=True)
    rows = torch.arange(n_rows + 2, dtype=torch.int32, device=keys.device)
    row_ptr = torch.searchsorted(sorted_keys, rows, out_int32=True)
    return RowIndex(row_ptr=row_ptr, pos=pos.to(torch.int32))


def _check_index(index: RowIndex, n_rows: int, n_pos: int, done, device):
    """The row index's and ``done``'s dtypes, shapes and device."""
    for name, x, shape in (("row_ptr", index.row_ptr, (n_rows + 2,)),
                           ("pos", index.pos, (n_pos,)),
                           ("done", done, done.shape[:1])):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if tuple(x.shape) != shape or x.ndim != 1:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")


def _check_bwd(feat, order, tile_lists, tile_counts, origins, entry, done,
               chunk_color, g_color, g_depth, tfin_gt, depth_index):
    """Shapes, dtypes and devices of the backward's arguments."""
    _check(feat, NFEAT, tile_lists, origins,
           (("order", order), ("tile_counts", tile_counts), ("done", done),
            ("depth_index", depth_index)))
    T, Kt = tile_lists.shape
    n_chunks = Kt // min(CHUNK, Kt)
    shapes = {"order": (order, (feat.shape[0] - 1,)),
              "tile_counts": (tile_counts, (T,)),
              "entry": (entry, (T, n_chunks, NPIX)), "done": (done, (T,)),
              "chunk_color": (chunk_color, (T, n_chunks, NPIX, 3)),
              "g_color": (g_color, (T, NPIX, 3)),
              "g_depth": (g_depth, (T, NPIX)), "tfin_gt": (tfin_gt, (T, NPIX)),
              "depth_index": (depth_index, (T, NPIX))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.device != feat.device:
            raise ValueError(f"{name} is on {x.device}, feat on {feat.device}")
        if x.is_floating_point() and x.dtype != feat.dtype:
            raise TypeError(f"{name} must be {feat.dtype}, got {x.dtype}")


def blend_bwd(
    feat: torch.Tensor,         # [V+1, 11] the forward's rows
    order: torch.Tensor,        # [V] int32
    tile_lists: torch.Tensor,   # [T, Kt] int32
    tile_counts: torch.Tensor,  # [T] int32
    origins: torch.Tensor,      # [T, 2]
    entry: torch.Tensor,        # [T, Kt/chunk, 256] the forward's entry T
    done: torch.Tensor,         # [T] int32 chunks the forward processed
    chunk_color: torch.Tensor,  # [T, Kt/chunk, 256, 3] the forward's chunk colours
    g_color: torch.Tensor,      # [T, 256, 3] cotangent of color
    g_depth: torch.Tensor,      # [T, 256]
    tfin_gt: torch.Tensor,      # [T, 256] T_final * cotangent of T_final
    depth_index: torch.Tensor,  # [T, 256] int32 the forward's depth hits
    opaque_threshold: float,
    index: "RowIndex | None" = None,   # row_index(tile_lists, tile_counts, V)
) -> torch.Tensor:
    """d loss / d feat [V+1, 11] of the blend (``_fused_bwd`` :726 and the
    TPU kernel ``blend_bwd_pallas`` :308), summed over every tile list the
    row appears in; the elig column and the sentinel row get 0.

    CUDA tensors run :func:`blend_bwd_partials` (K2) then
    :func:`blend_bwd_reduce`, through ``index`` (built here when the caller
    has none); every sum has a fixed order, so the result is bitwise
    repeatable.  CPU tensors run :func:`blend_bwd_reference`."""
    if index is not None:
        _check_index(index, feat.shape[0] - 1, tile_lists.numel(), done,
                     feat.device)
    if feat.device.type == "cpu":
        _check_bwd(feat, order, tile_lists, tile_counts, origins, entry, done,
                   chunk_color, g_color, g_depth, tfin_gt, depth_index)
        return blend_bwd_reference(feat, order, tile_lists, tile_counts,
                                   origins, entry, done, chunk_color, g_color,
                                   g_depth, tfin_gt, depth_index,
                                   opaque_threshold)
    partials = blend_bwd_partials(feat, order, tile_lists, tile_counts,
                                  origins, entry, done, chunk_color, g_color,
                                  g_depth, tfin_gt, depth_index,
                                  opaque_threshold)
    if index is None:
        index = row_index(tile_lists, tile_counts, feat.shape[0] - 1)
    return blend_bwd_reduce(partials, index, done)


def blend_bwd_partials(feat, order, tile_lists, tile_counts, origins, entry,
                       done, chunk_color, g_color, g_depth, tfin_gt,
                       depth_index, opaque_threshold):
    """The backward's gradient of every tile-list position, [T, Kt, 10]
    (:func:`blend_bwd`'s arguments but the index).  CUDA
    tensors launch K2, which writes the positions below the tile's count
    inside its first ``done`` chunks and leaves the others undefined; CPU
    tensors run :func:`blend_bwd_partials_reference`."""
    _check_bwd(feat, order, tile_lists, tile_counts, origins, entry, done,
               chunk_color, g_color, g_depth, tfin_gt, depth_index)
    if feat.device.type == "cpu":
        return blend_bwd_partials_reference(
            feat, order, tile_lists, tile_counts, origins, entry, done,
            chunk_color, g_color, g_depth, tfin_gt, depth_index,
            opaque_threshold)
    T, Kt = tile_lists.shape
    args = [x.contiguous() for x in (feat, order, tile_lists, tile_counts,
                                     origins, entry, done, chunk_color,
                                     g_color, g_depth, tfin_gt, depth_index)]
    partials = torch.empty((T, Kt, NGRAD), dtype=torch.float32,
                           device=feat.device)
    with torch.cuda.device(feat.device):
        if T:
            _launch(_kernel_lib("blend_bwd").rtg_blend_bwd, "blend_bwd",
                    *_ptrs(*args[:2]), order.shape[0], *_ptrs(*args[2:]),
                    T, Kt, float(opaque_threshold), partials.data_ptr())
    return partials


def blend_bwd_reduce(partials: torch.Tensor, index: RowIndex,
                     done: torch.Tensor) -> torch.Tensor:
    """Each feature row's sum of its positions' ``partials`` [T, Kt, 10], in
    ascending (tile, position) order, skipping chunks at or past ``done``:
    [V+1, 11], the elig column and the sentinel row V 0.  CUDA tensors
    launch the reduce kernel of ``csrc/blend_bwd.cu``; CPU tensors run
    :func:`blend_bwd_reduce_reference`."""
    T, Kt = partials.shape[:2]
    V = index.row_ptr.shape[0] - 2
    if partials.shape != (T, Kt, NGRAD):
        raise ValueError(f"partials must be [T, Kt, {NGRAD}], got "
                         f"{tuple(partials.shape)}")
    pdt = partials.dtype
    if pdt != torch.float32 and not (pdt == torch.float64
                                     and partials.device.type == "cpu"):
        raise TypeError(f"partials must be float32, got {pdt}")
    if done.shape != (T,):
        raise ValueError(f"done must be ({T},), got {tuple(done.shape)}")
    _check_index(index, V, T * Kt, done, partials.device)
    if partials.device.type == "cpu":
        return blend_bwd_reduce_reference(partials, index, done)
    if partials.device.type != "cuda":
        raise ValueError(f"the reduce runs on cuda or cpu, not {partials.device}")
    args = [x.contiguous() for x in (partials, index.row_ptr, index.pos, done)]
    g_feat = torch.empty((V + 1, NFEAT), dtype=torch.float32,
                         device=partials.device)
    with torch.cuda.device(partials.device):
        _launch(_kernel_lib("blend_bwd").rtg_blend_bwd_reduce,
                "blend_bwd_reduce", *_ptrs(*args), V, Kt, g_feat.data_ptr())
    return g_feat


def blend_bwd_reference(feat, order, tile_lists, tile_counts, origins, entry,
                        done, chunk_color, g_color, g_depth, tfin_gt,
                        depth_index, opaque_threshold, index=None):
    """Plain PyTorch twin of :func:`blend_bwd` (same arguments): the
    per-position gradients of :func:`_bwd_chunks` index-added into the
    feature rows chunk by chunk (sequential on the CPU).  It forms the
    chunk totals itself and needs no index, so ``tile_counts``,
    ``chunk_color`` and ``index`` only share the kernels' arguments."""
    g_feat = torch.zeros_like(feat)
    for _, _, rows, g in _bwd_chunks(feat, order, tile_lists, origins, entry,
                                     done, g_color, g_depth, tfin_gt,
                                     depth_index, opaque_threshold):
        g = torch.cat([g, torch.zeros_like(g[..., :1])], dim=-1)
        g_feat.index_add_(0, rows.reshape(-1), g.reshape(-1, NFEAT))
    # the sentinel row is a constant, not a feature
    g_feat[-1] = 0.0
    return g_feat


def blend_bwd_partials_reference(feat, order, tile_lists, tile_counts,
                                 origins, entry, done, chunk_color, g_color,
                                 g_depth, tfin_gt, depth_index,
                                 opaque_threshold):
    """Plain PyTorch twin of :func:`blend_bwd_partials`: :func:`_bwd_chunks`
    written into [T, Kt, 10]; positions never processed are 0."""
    chunk = min(CHUNK, tile_lists.shape[1])
    partials = feat.new_zeros(tile_lists.shape + (NGRAD,))
    for a, c, _, g in _bwd_chunks(feat, order, tile_lists, origins, entry,
                                  done, g_color, g_depth, tfin_gt,
                                  depth_index, opaque_threshold):
        partials[a, c * chunk:(c + 1) * chunk] = g
    return partials


def _bwd_chunks(feat, order, tile_lists, origins, entry, done, g_color,
                g_depth, tfin_gt, depth_index, opaque_threshold):
    """The backward chunk by chunk, from the last one processed down to 0,
    over all tiles that processed a chunk at once, with the JAX
    ``_fused_bwd`` math — log-space transmittance from the entry T, suffix
    sums as a triangular matmul, the pixel reductions summed directly (the
    moment-basis matmul is a TPU layout device and is not carried over).
    Whole chunks: past the count the sentinel rows give 0.  Yields (tiles
    [A], chunk c, their rows [A, C], per-position gradients [A, C, 10])."""
    dt = feat.dtype
    T_tiles, Kt = tile_lists.shape
    chunk = min(CHUNK, Kt)
    lists = tile_lists.long()
    order_pad = torch.cat([order, order.new_full((1,), -1)])
    pix = tile_pixels(origins)
    tri_lo = torch.tril(torch.ones(chunk, chunk, dtype=dt, device=feat.device),
                        diagonal=-1)   # row j feeds column i < j: suffix-excl
    tri_up = tri_lo.T.contiguous()     # row j feeds column i > j: prefix-excl
    s_carry = torch.zeros((T_tiles, NPIX), dtype=dt, device=feat.device)
    n_done = done.long()
    for c in range(int(n_done.max()) - 1 if T_tiles else -1, -1, -1):
        a = torch.nonzero(n_done > c).squeeze(1)
        rows = lists[a, c * chunk:(c + 1) * chunk]            # [A, C]
        f = feat[rows]                                        # [A, C, 11]
        gidx = order_pad[rows]
        alpha, e, gate, dx, dy = _chunk_alphas(f, pix[a])
        opaque = (f[:, None, :, 10] > 0.5) & (alpha >= opaque_threshold)

        excl = torch.exp(torch.log1p(-alpha) @ tri_up)
        T_in = entry[a, c][:, :, None] * excl                 # [A, 256, C]
        w = alpha * T_in
        gc = g_color[a]                                       # [A, 256, 3]
        rgbdot = gc @ f[:, :, 6:9].transpose(1, 2)            # [A, 256, C]
        wg = w * rgbdot
        s_total = wg @ tri_lo + s_carry[a][:, :, None]
        galpha = T_in * rgbdot - (s_total + tfin_gt[a][:, :, None]) / (1.0 - alpha)
        galpha = torch.where(gate, galpha, 0.0)
        gpow = galpha * alpha

        ca, cb, cc = (f[:, None, :, k] for k in (2, 3, 4))
        didx = depth_index[a][:, :, None]
        hit = opaque & (gidx[:, None, :] == didx) & (didx >= 0)
        g_rgb = w.transpose(1, 2) @ gc                        # [A, C, 3]
        yield a, c, rows, torch.stack([
            torch.sum(gpow * (ca * dx + cb * dy), dim=1),
            torch.sum(gpow * (cc * dy + cb * dx), dim=1),
            torch.sum(gpow * (-0.5 * dx * dx), dim=1),
            torch.sum(gpow * (-dx * dy), dim=1),
            torch.sum(gpow * (-0.5 * dy * dy), dim=1),
            torch.sum(torch.where(hit, g_depth[a][:, :, None], 0.0), dim=1),
            g_rgb[..., 0], g_rgb[..., 1], g_rgb[..., 2],
            torch.sum(galpha * e, dim=1),
        ], dim=-1)                                            # [A, C, 10]
        s_carry[a] = s_carry[a] + torch.sum(wg, dim=2)


def blend_bwd_reduce_reference(partials, index: RowIndex, done):
    """Plain PyTorch twin of :func:`blend_bwd_reduce`, in the kernel's order
    of additions, so on the same inputs the two agree bitwise: lane l of
    row r's 16 adds the row's positions l, l + 16, ... in order; the 16 lane
    sums are then added pairwise over lane bits 3, 2, 1, 0."""
    T, Kt = partials.shape[:2]
    chunk = min(CHUNK, Kt) if Kt else 1
    V = index.row_ptr.shape[0] - 2
    q = index.pos.long()
    live = (q % max(Kt, 1)) // chunk < done.long()[q // max(Kt, 1)]
    vals = torch.where(live[:, None], partials.reshape(-1, NGRAD)[q], 0.0)
    start = index.row_ptr[:-2].long()
    length = index.row_ptr[1:-1].long() - start
    lane = torch.arange(REDUCE_LANES, device=partials.device)
    acc = partials.new_zeros((V, REDUCE_LANES, NGRAD))
    for r in range(-(-int(length.max()) // REDUCE_LANES) if V else 0):
        i = r * REDUCE_LANES + lane[None]                          # [V, 16]
        has = i < length[:, None]
        at = torch.where(has, start[:, None] + i, 0)
        acc = acc + torch.where(has[..., None], vals[at], 0.0)
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    g_feat = partials.new_zeros((V + 1, NFEAT))
    g_feat[:V, :NGRAD] = acc[:, 0]
    return g_feat


# ---------------------------------------------------------------------------
# the differentiable blend of the optimize loop
# ---------------------------------------------------------------------------

class BlendFunction(torch.autograd.Function):
    """``blend_tiles_fused`` (:653): the forward is :func:`blend_tiles` in
    residual mode (K1), the backward :func:`blend_bwd` (K2 and the reduce).
    Differentiable in ``feat`` only, through color, depth and T_final; the
    index maps and hit weights are not differentiable (:602-604).

    ``BlendFunction.apply(feat, order, tile_lists, tile_counts, origins,
    opaque_threshold, T_threshold, index)`` returns the seven TileOutputs
    fields; ``index`` is the lists' :func:`row_index`, or None to build it
    in the backward."""

    @staticmethod
    def forward(ctx, feat, order, tile_lists, tile_counts, origins,
                opaque_threshold, T_threshold, index=None):
        out, entry, done, chunk_color = blend_tiles(
            feat, order, tile_lists, tile_counts, origins, opaque_threshold,
            T_threshold, residuals=True)
        ctx.save_for_backward(feat, order, tile_lists, tile_counts, origins,
                              entry, done, chunk_color, out.T_final,
                              out.depth_index)
        ctx.opaque_threshold = opaque_threshold
        ctx.index = index
        ctx.mark_non_differentiable(out.depth_index, out.color_index,
                                    out.depth_weight, out.color_weight)
        return tuple(out)

    @staticmethod
    def backward(ctx, g_color, g_depth, _gdi, _gci, _gdw, _gcw, g_T):
        (feat, order, tile_lists, tile_counts, origins, entry, done,
         chunk_color, T_fin, didx) = ctx.saved_tensors
        zero = torch.zeros_like(T_fin)
        g_color = zero[..., None].expand(-1, -1, 3) if g_color is None else g_color
        # positional, so a caller that wraps blend_bwd sees every argument
        g_feat = blend_bwd(
            feat, order, tile_lists, tile_counts, origins, entry, done,
            chunk_color, g_color, zero if g_depth is None else g_depth,
            zero if g_T is None else T_fin * g_T, didx, ctx.opaque_threshold,
            ctx.index)
        return g_feat, None, None, None, None, None, None, None


def blend_tiles_fused(feat, order, tile_lists, tile_counts, origins,
                      opaque_threshold, T_threshold=1e-4,
                      index=None) -> TileOutputs:
    """The differentiable blend as a :class:`TileOutputs`; ``index`` as in
    :class:`BlendFunction`."""
    return TileOutputs(*BlendFunction.apply(
        feat, order, tile_lists, tile_counts, origins, opaque_threshold,
        T_threshold, index))
