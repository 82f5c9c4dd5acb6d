"""Depth sorting and hierarchical tile binning with static shapes.

Port of ``rtgslam_tpu/ops/rasterize/binning.py``: one global depth sort of
the fixed-capacity array truncated to ``max_visible``, then coarse binning
into 128x128-pixel blocks and fine binning into their 16x16 tiles.  Each
per-bin list keeps ascending sorted-space indices, so every tile list is
front to back.  Overflow beyond a capacity drops the farthest entries of
that bin and is counted.

The tile grid is block-major (8x8 tiles per block) and padded to whole
blocks; :func:`tile_origins` and :func:`scatter_tiles` map it to pixels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16
TILES_PER_BLOCK = 8           # 8x8 tiles per block
BLOCK = TILE * TILES_PER_BLOCK  # 128 px


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Binning(NamedTuple):
    tile_lists: torch.Tensor   # [T, Kt] int32 sorted-space indices (sentinel V)
    tile_counts: torch.Tensor  # [T] int32
    order: torch.Tensor        # [V] int32 sorted -> original index
    n_visible: torch.Tensor    # [] int32 valid prefix of ``order``
    overflow: torch.Tensor     # [] int32 dropped entries (visible+block+tile)


def tile_grid_shape(height: int, width: int):
    """(tiles_y, tiles_x) matching the reference tile-mask layout."""
    return cdiv(height, TILE), cdiv(width, TILE)


def _block_grid(height: int, width: int):
    tiles_y, tiles_x = tile_grid_shape(height, width)
    return cdiv(tiles_y, TILES_PER_BLOCK), cdiv(tiles_x, TILES_PER_BLOCK)


def compact_rows(hit: torch.Tensor, capacity: int, fill: int):
    """Per-row stable compaction of a [..., N] boolean mask into index
    lists (``binning.py::_compact_rows`` :53).

    Returns (lists [..., capacity] int32, ascending set-bit indices padded
    with ``fill``; counts [...] int32 clipped to ``capacity``).  The k-th
    set bit lands at position k by a cumsum, the same lists the JAX top_k
    formulation returns."""
    n = hit.shape[-1]
    pos = torch.cumsum(hit, dim=-1, dtype=torch.int32) - 1
    keep = hit & (pos < capacity)
    # one spill column absorbs everything not kept, then is cut off
    dest = torch.where(keep, pos, capacity).long()
    out = torch.full(hit.shape[:-1] + (capacity + 1,), fill, dtype=torch.int32,
                     device=hit.device)
    iota = torch.arange(n, dtype=torch.int32, device=hit.device)
    out.scatter_(-1, dest, iota.expand_as(dest).contiguous())
    counts = torch.clamp(hit.sum(dim=-1, dtype=torch.int32), max=capacity)
    return out[..., :capacity], counts


def depth_order(keys: torch.Tensor, V: int) -> torch.Tensor:
    """The ``V`` smallest keys' indices, ascending, ties to the lowest index
    (``lax.top_k(-keys, V)`` semantics)."""
    return torch.sort(keys, stable=True).indices[:V].to(torch.int32)


def bin_gaussians(proj, height: int, width: int, block_capacity: int,
                  tile_capacity: int, max_visible: int,
                  tile_mask: Optional[torch.Tensor] = None) -> Binning:
    """Build per-tile front-to-back index lists (``bin_gaussians`` :92).
    ``tile_mask`` [tiles_y, tiles_x]: tiles at 0 get empty lists."""
    P = proj.depth.shape[0]
    V = min(max_visible, P)
    keys = torch.where(proj.visible, proj.depth, torch.inf)
    order = depth_order(keys, V)
    n_visible = proj.visible.sum(dtype=torch.int32)
    n_valid = torch.clamp(n_visible, max=V)
    o = order.long()
    mean2d = proj.mean2d[o]
    radius = proj.radius[o]
    valid = torch.arange(V, device=keys.device) < n_valid
    tile_lists, tile_counts, bin_overflow = bin_sorted(
        mean2d[:, 0], mean2d[:, 1], radius * radius, valid,
        height, width, block_capacity, tile_capacity, tile_mask)
    return Binning(tile_lists=tile_lists, tile_counts=tile_counts, order=order,
                   n_visible=n_valid,
                   overflow=(n_visible - n_valid + bin_overflow).to(torch.int32))


def bin_sorted(mx, my, r2, valid, height: int, width: int,
               block_capacity: int, tile_capacity: int,
               tile_mask: Optional[torch.Tensor] = None):
    """Block/tile binning of an already depth-sorted working set
    (``bin_sorted`` :138).  Returns (tile_lists [T, Kt] with sentinel V,
    tile_counts [T], block+tile overflow)."""
    V = mx.shape[0]
    device = mx.device
    blocks_y, blocks_x = _block_grid(height, width)
    B = blocks_y * blocks_x
    T = B * TILES_PER_BLOCK * TILES_PER_BLOCK

    bx = torch.arange(blocks_x, dtype=torch.float32, device=device) * BLOCK
    by = torch.arange(blocks_y, dtype=torch.float32, device=device) * BLOCK
    block_x0 = bx.repeat(blocks_y)                  # [B]
    block_y0 = by.repeat_interleave(blocks_x)

    # circle-vs-rect overlap of each entry's 3-sigma disc with each block
    nx = torch.minimum(torch.maximum(mx[None, :], block_x0[:, None]),
                       (block_x0 + BLOCK)[:, None])
    ny = torch.minimum(torch.maximum(my[None, :], block_y0[:, None]),
                       (block_y0 + BLOCK)[:, None])
    ddx = mx[None, :] - nx
    ddy = my[None, :] - ny
    hit_block = valid[None, :] & (ddx * ddx + ddy * ddy <= r2[None, :])  # [B, V]
    block_total = hit_block.sum(dim=1, dtype=torch.int32)
    block_lists, block_counts = compact_rows(hit_block, block_capacity, V)
    block_overflow = (block_total - block_counts).sum(dtype=torch.int32)

    def gather_pad(arr, fill_value):
        padded = torch.cat([arr, arr.new_full((1,), fill_value)])
        return padded[block_lists.long()]           # [B, Kb]

    gmx = gather_pad(mx, torch.inf)
    gmy = gather_pad(my, torch.inf)
    gr2 = gather_pad(r2, 0.0)

    txy = torch.arange(TILES_PER_BLOCK, dtype=torch.float32, device=device) * TILE
    tile_x0 = block_x0[:, None] + txy.repeat(TILES_PER_BLOCK)[None, :]   # [B, 64]
    tile_y0 = block_y0[:, None] + txy.repeat_interleave(TILES_PER_BLOCK)[None, :]

    nx = torch.minimum(torch.maximum(gmx[:, None, :], tile_x0[:, :, None]),
                       (tile_x0 + TILE)[:, :, None])
    ny = torch.minimum(torch.maximum(gmy[:, None, :], tile_y0[:, :, None]),
                       (tile_y0 + TILE)[:, :, None])
    ddx = gmx[:, None, :] - nx
    ddy = gmy[:, None, :] - ny
    hit_tile = (ddx * ddx + ddy * ddy) <= gr2[:, None, :]   # [B, 64, Kb]
    if tile_mask is not None:
        m = tile_mask_flat(tile_mask, height, width).reshape(B, -1)
        hit_tile = hit_tile & (m[:, :, None] > 0)
    tile_total = hit_tile.sum(dim=2, dtype=torch.int32)
    tile_pos, tile_counts = compact_rows(hit_tile, tile_capacity, block_capacity)
    tile_overflow = (tile_total - tile_counts).sum(dtype=torch.int32)

    # positions into the block list -> global sorted indices
    block_lists_pad = torch.cat(
        [block_lists, block_lists.new_full((B, 1), V)], dim=1)       # [B, Kb+1]
    tile_lists = torch.gather(
        block_lists_pad[:, None, :].expand(-1, TILES_PER_BLOCK ** 2, -1), 2,
        tile_pos.long())
    return (tile_lists.reshape(T, tile_capacity), tile_counts.reshape(T),
            block_overflow + tile_overflow)


def tile_mask_flat(tile_mask: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[tiles_y, tiles_x] mask -> [T] in the block-major flat tile layout of
    tile_lists / tile_counts (``tile_mask_flat`` :232): zeroing the counts of
    masked tiles after binning is blend-equivalent to binning with the mask."""
    tiles_y, tiles_x = tile_grid_shape(height, width)
    blocks_y, blocks_x = _block_grid(height, width)
    padded = torch.zeros((blocks_y * TILES_PER_BLOCK, blocks_x * TILES_PER_BLOCK),
                         dtype=torch.int32, device=tile_mask.device)
    padded[:tiles_y, :tiles_x] = tile_mask.to(torch.int32)
    m = padded.reshape(blocks_y, TILES_PER_BLOCK, blocks_x, TILES_PER_BLOCK)
    return m.permute(0, 2, 1, 3).reshape(-1)


def tile_origins(height: int, width: int, device=None) -> torch.Tensor:
    """[T, 2] (x, y) pixel origin of each tile in block-major layout."""
    blocks_y, blocks_x = _block_grid(height, width)
    bx = torch.arange(blocks_x, device=device) * BLOCK
    by = torch.arange(blocks_y, device=device) * BLOCK
    t = torch.arange(TILES_PER_BLOCK, device=device) * TILE
    ox = (bx.repeat(blocks_y)[:, None] + t.repeat(TILES_PER_BLOCK)[None, :])
    oy = (by.repeat_interleave(blocks_x)[:, None]
          + t.repeat_interleave(TILES_PER_BLOCK)[None, :])
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1).to(torch.float32)


def scatter_tiles(tile_values: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[T, TILE*TILE, C] per-tile pixels (block-major) -> [H, W, C] image."""
    blocks_y, blocks_x = _block_grid(height, width)
    C = tile_values.shape[-1]
    v = tile_values.reshape(blocks_y, blocks_x, TILES_PER_BLOCK,
                            TILES_PER_BLOCK, TILE, TILE, C)
    v = v.permute(0, 2, 4, 1, 3, 5, 6)   # [by, tile_y, py, bx, tile_x, px, C]
    img = v.reshape(blocks_y * TILES_PER_BLOCK * TILE,
                    blocks_x * TILES_PER_BLOCK * TILE, C)
    return img[:height, :width]
