"""Tile-sharded (spatial-parallel) rendering over a mesh.

Port of ``rtgslam_tpu/parallel/sp_render.py``: for one camera the blend,
the rasterizer's largest cost, is split over the tile axis.  Projection,
the depth sort, binning and shading stay replicated (one pass, on the
gaussians' device); every shard blends its slice of the tiles with K1 in
inference mode on its own device, and the slices are put back together in
shard order.  The blend is per tile, so the result equals
:func:`..ops.rasterize.api.render` bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.rasterize import api, binning, blend
from .mesh import Mesh


def pad_tiles(x: torch.Tensor, n: int, fill) -> torch.Tensor:
    """``x`` with its leading (tile) axis padded by ``fill`` rows to a
    multiple of ``n``."""
    pad = (-x.shape[0]) % n
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def sp_render(gaussians: Dict[str, torch.Tensor], camera: Dict[str, torch.Tensor],
              settings: api.RasterSettings, mesh: Mesh,
              tile_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """:func:`api.render`'s output contract (the seven maps, the gathered
    normal and the binning overflow) with the blend sharded over ``mesh``
    (``sp_render`` :29).  Inference only.  The tile axis is padded to a
    multiple of the shard count with count-0 tiles whose lists hold the
    sentinel row; their outputs are cut off again."""
    H, W = settings.height, settings.width
    feat, bins = api._sorted_pass(gaussians, camera["w2c"], camera["K"],
                                  camera["campos"], settings, tile_mask)
    V = feat.shape[0] - 1
    T = bins.tile_lists.shape[0]
    n = mesh.size
    lists = pad_tiles(bins.tile_lists, n, V)
    counts = pad_tiles(bins.tile_counts, n, 0)
    origins = pad_tiles(binning.tile_origins(H, W, feat.device), n, 0.0)
    per = lists.shape[0] // n
    parts = []
    for s, (f_s, o_s) in enumerate(zip(mesh.broadcast(feat),
                                       mesh.broadcast(bins.order))):
        dev = f_s.device
        rows = slice(s * per, (s + 1) * per)
        parts.append(blend.blend_tiles(
            f_s, o_s, lists[rows].to(dev), counts[rows].to(dev),
            origins[rows].to(dev), settings.opaque_threshold,
            settings.T_threshold))
    home = feat.device
    tiles = blend.TileOutputs(*(
        torch.cat([getattr(p, name).to(home) for p in parts])[:T]
        for name in blend.TileOutputs._fields))
    return api._assemble_outputs(tiles, gaussians["normal"], bins.overflow,
                                 H, W)
