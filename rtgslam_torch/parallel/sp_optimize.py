"""Tile-sharded (spatial-parallel) compact optimization over a mesh.

Port of ``rtgslam_tpu/parallel/sp_optimize.py``: the compact loop of
``models/optimize.py::optimize_execute`` with the blend of its tile axis
split over the shards.  Each shard blends its slice of the compact tiles
forward (K1 in residual mode) and differentiates it backward (K2) on its
own device.  The optimized pool's rows, their projection, the loss and
Adam stay replicated: in one controller they run once.

The JAX version forms each device's loss from its own tiles over global
denominators and ``psum``s the parameter gradients, which recovers the
one-device gradient up to the order of the additions.  At rows whose tiles
fall on several shards the two orders can round a near-cancelling sum
apart, and Adam's eps 1e-15 turns that into parameter gaps: on an H100 at
680x1200 one of them came out past ``tests/test_parallel.py``'s own
tolerance.  So here the shards' K2 partials (one per tile-list position)
are put back in tile order and summed per feature row by one reduce over
the index of all the compact lists, which is the one-device backward's
order (``blend.blend_bwd`` on CUDA): the gradient is the one-device
gradient, and the loss is the one-device loss (``optimize._total`` on the
image), bit for bit on the card.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..models import optimize as opt_mod
from ..models.gaussian_map import MapState
from ..ops.rasterize import api, blend
from .mesh import Mesh
from .sp_render import pad_tiles

Part = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


class ShardedBlend(torch.autograd.Function):
    """:class:`blend.BlendFunction` over tiles split into ``parts`` (each
    shard's lists, counts and origins on its device, in tile order):
    forward, K1 in residual mode on every part, the outputs concatenated on
    the feature rows' device; backward, K2 on every part, its partials
    concatenated in the same order, and one reduce through ``index``, the
    row index of all the parts' lists.  Returns the seven TileOutputs
    fields over the concatenated tiles."""

    @staticmethod
    def forward(ctx, feat, order, parts: List[Part], index, opaque_threshold,
                T_threshold):
        home, outs, ctx.saved = feat.device, [], []
        for lists, counts, origins in parts:
            dev = lists.device
            f_s, o_s = feat.to(dev), order.to(dev)
            out, entry, done, chunk_color = blend.blend_tiles(
                f_s, o_s, lists, counts, origins, opaque_threshold,
                T_threshold, residuals=True)
            outs.append(out)
            ctx.saved.append((f_s, o_s, lists, counts, origins, entry, done,
                              chunk_color, out.T_final, out.depth_index))
        tiles = [torch.cat([getattr(o, name).to(home) for o in outs])
                 for name in blend.TileOutputs._fields]
        ctx.index, ctx.opaque_threshold = index, opaque_threshold
        ctx.mark_non_differentiable(*tiles[2:6])
        return tuple(tiles)

    @staticmethod
    def backward(ctx, g_color, g_depth, _gdi, _gci, _gdw, _gcw, g_T):
        partials, dones, start = [], [], 0
        for (f_s, o_s, lists, counts, origins, entry, done, chunk_color,
             T_fin, didx) in ctx.saved:
            dev, rows = lists.device, slice(start, start + lists.shape[0])
            start = rows.stop
            zero = torch.zeros_like(T_fin)
            gc = zero[..., None].expand(-1, -1, 3) if g_color is None \
                else g_color[rows].to(dev)
            gd = zero if g_depth is None else g_depth[rows].to(dev)
            gt = zero if g_T is None else T_fin * g_T[rows].to(dev)
            partials.append(blend.blend_bwd_partials(
                f_s, o_s, lists, counts, origins, entry, done, chunk_color,
                gc, gd, gt, didx, ctx.opaque_threshold))
            dones.append(done)
        home = ctx.index.pos.device
        g_feat = blend.blend_bwd_reduce(
            torch.cat([p.to(home) for p in partials]), ctx.index,
            torch.cat([d.to(home) for d in dones]))
        ctx.saved = None
        return g_feat, None, None, None, None, None


def sharded_blend(mesh: Mesh, lists: torch.Tensor, counts: torch.Tensor,
                  origins: torch.Tensor, n_rows: int):
    """The blend of one frame's compact tiles (``lists`` [Tc, Ktc] over
    ``n_rows`` feature rows, sentinel ``n_rows``) split over ``mesh``: the
    tile axis padded to a multiple of the shard count with count-0 tiles,
    one contiguous slice per shard, and the row index of the padded lists.
    Returns a function with :func:`blend.blend_tiles_fused`'s arguments
    (those of the lists stand for this split) whose TileOutputs cover the
    ``Tc`` tiles."""
    n, T = mesh.size, lists.shape[0]
    pl = pad_tiles(lists, n, n_rows)
    pc, po = pad_tiles(counts, n, 0), pad_tiles(origins, n, 0.0)
    per = pl.shape[0] // n
    parts = [tuple(x[s * per:(s + 1) * per].to(d) for x in (pl, pc, po))
             for s, d in enumerate(mesh.devices)]
    index = blend.row_index(pl, pc, n_rows)

    def fn(feat, order, _lists, _counts, _origins, opaque_threshold,
           T_threshold, _index=None):
        tiles = ShardedBlend.apply(feat, order, parts, index,
                                   opaque_threshold, T_threshold)
        return blend.TileOutputs(*(x[:T] for x in tiles))
    return fn


def sp_optimize_execute(state: MapState, colors, depths, normals, w2cs, Ks,
                        camposes, rmasks, lists_orig, counts,
                        pool_rows: torch.Tensor, n_pool: int,
                        tile_rows: torch.Tensor, frame_seq: Sequence[int],
                        n_iters: int, lrs, weights,
                        settings: api.RasterSettings, mode: str,
                        max_weight: float, Ktc: int, mesh: Mesh):
    """``optimize.optimize_execute`` with the blend of the tile axis of
    ``tile_rows`` [F, Tc] sharded over ``mesh`` (``sp_optimize_execute``
    :134).  ``Tc`` need not divide over the mesh.  Updates ``state``
    (scatter back, then in local mode the history merge); returns the last
    iteration's report."""
    return opt_mod.optimize_execute(
        state, colors, depths, normals, w2cs, Ks, camposes, rmasks,
        lists_orig, counts, pool_rows, n_pool, tile_rows, frame_seq, n_iters,
        lrs, weights, settings, mode, max_weight, Ktc,
        blend_for=lambda *split: sharded_blend(mesh, *split))
