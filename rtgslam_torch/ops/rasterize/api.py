"""Renderer API: port of ``rtgslam_tpu/ops/rasterize/api.py``.

``render`` returns, in [H, W, C] layout: render, depth, normal,
color_index_map, depth_index_map, color_hit_weight, depth_hit_weight,
T_map and the bin overflow count.  Index maps hold map slot indices
(-1 = no hit).  Inference blends go through :func:`blend.blend_tiles`
(kernel K1), differentiable ones through :class:`blend.BlendFunction` (K1
in residual mode forward, K2 backward) and the mask renders through
:func:`blend.blend_transmission` (K1's transmission mode).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import binning, blend
from .project import project_geometry, shade_cols


@dataclasses.dataclass(frozen=True)
class RasterSettings:
    """Static render configuration (``api.py::RasterSettings`` :30, without
    the Pallas flags)."""

    height: int
    width: int
    sh_degree: int = 3
    opaque_threshold: float = 0.6
    depth_threshold: float = 1.0
    normal_threshold: float = 0.5     # cos(renderer_normal_threshold deg)
    color_sigma: float = 3.0
    T_threshold: float = 1e-4
    scale_modifier: float = 1.0
    block_capacity: int = 4096
    tile_capacity: int = 1024
    max_visible: int = 131072

    @classmethod
    def from_args(cls, args, height: int, width: int,
                  opaque_threshold: Optional[float] = None) -> "RasterSettings":
        sh_degree = args.active_sh_degree
        if sh_degree < 0:
            sh_degree = args.max_sh_degree
        return cls(
            height=height,
            width=width,
            sh_degree=sh_degree,
            opaque_threshold=(args.renderer_opaque_threshold
                              if opaque_threshold is None else opaque_threshold),
            depth_threshold=args.renderer_depth_threshold,
            normal_threshold=float(np.cos(np.deg2rad(args.renderer_normal_threshold))),
            color_sigma=args.color_sigma,
            block_capacity=getattr(args, "block_capacity", 4096),
            tile_capacity=getattr(args, "tile_capacity", 1024),
            max_visible=getattr(args, "max_visible", 131072),
        )


def _feature_rows(geo, o, r, g, b, opacity, elig) -> torch.Tensor:
    """[V+1, 11] blend rows of the entries ``o`` (all when None) with the
    zero sentinel row V (``_pack_features`` :131)."""
    sel = (lambda x: x) if o is None else (lambda x: x[o])
    feat = torch.stack([
        sel(geo.mean2d[:, 0]), sel(geo.mean2d[:, 1]), sel(geo.conic[:, 0]),
        sel(geo.conic[:, 1]), sel(geo.conic[:, 2]), sel(geo.depth), r, g, b,
        sel(opacity.reshape(-1)), elig.to(r.dtype)], dim=-1)
    return torch.cat([feat, feat.new_zeros((1, blend.NFEAT))])


def _sorted_pass(gaussians: Dict[str, torch.Tensor], w2c, K, campos,
                 settings: RasterSettings, tile_mask=None):
    """Project, depth-sort, bin and shade: everything before the blend.

    Returns (feat [V+1, 11] depth-sorted feature rows with the zero sentinel
    row V, Binning)."""
    H, W = settings.height, settings.width
    geo = project_geometry(gaussians["xyz"], gaussians["scales"],
                           gaussians["rotations"], gaussians["alive"],
                           w2c, K, W, H, settings.scale_modifier)
    bins = binning.bin_gaussians(geo, H, W, settings.block_capacity,
                                 settings.tile_capacity, settings.max_visible,
                                 tile_mask)
    o = bins.order.long()
    P = gaussians["xyz"].shape[0]
    r, g, b, elig = shade_cols(
        gaussians["xyz"][o], gaussians["shs"].reshape(P, -1)[o],
        gaussians["normal"][o], campos, settings.sh_degree,
        settings.normal_threshold)
    return _feature_rows(geo, o, r, g, b, gaussians["opacity"], elig), bins


def _blend(feat, bins, settings: RasterSettings,
           differentiable: bool = False) -> blend.TileOutputs:
    fn = blend.blend_tiles_fused if differentiable else blend.blend_tiles
    return fn(feat, bins.order, bins.tile_lists, bins.tile_counts,
              binning.tile_origins(settings.height, settings.width, feat.device),
              settings.opaque_threshold, settings.T_threshold)


def _to_image(x: torch.Tensor, channels: int, H: int, W: int) -> torch.Tensor:
    return binning.scatter_tiles(
        x.reshape(x.shape[0], blend.TILE * blend.TILE, channels), H, W)


def _assemble_outputs(tiles: blend.TileOutputs, normals: torch.Tensor,
                      overflow, H: int, W: int) -> Dict[str, torch.Tensor]:
    """Tile-major blend outputs -> the render's [H, W, C] output dict
    (``_assemble_outputs`` :175)."""
    depth_index = _to_image(tiles.depth_index[..., None], 1, H, W)[..., 0]
    # the hit's normal, 0 without a hit.  An embedding lookup with the
    # zero pad row as padding_idx: its backward skips the no-hit pixels,
    # where a gather's backward would serialize their hundreds of
    # thousands of duplicate indices on one row
    pad = normals.shape[0]
    normal = F.embedding(
        torch.where(depth_index >= 0, depth_index, pad).long(),
        torch.cat([normals, normals.new_zeros((1, 3))]), padding_idx=pad)
    return {
        "render": _to_image(tiles.color, 3, H, W),
        "depth": _to_image(tiles.depth[..., None], 1, H, W),
        "normal": normal,
        "color_index_map": _to_image(tiles.color_index[..., None], 1, H, W)[..., 0],
        "depth_index_map": depth_index,
        "color_hit_weight": _to_image(tiles.color_weight[..., None], 1, H, W),
        "depth_hit_weight": _to_image(tiles.depth_weight[..., None], 1, H, W),
        "T_map": _to_image(tiles.T_final[..., None], 1, H, W),
        "overflow": overflow,
    }


def render(gaussians: Dict[str, torch.Tensor], camera: Dict[str, torch.Tensor],
           settings: RasterSettings, tile_mask: Optional[torch.Tensor] = None,
           differentiable: bool = False) -> Dict[str, torch.Tensor]:
    """Render the map from a camera (``render`` :623, ``_render_impl`` :103).

    ``gaussians``: activated xyz [P,3], scales [P,3], rotations [P,4],
    opacity [P,1], shs [P,K,3], normal [P,3], alive [P] bool.
    ``camera``: w2c [4,4], K [3,3], campos [3] tensors.  ``tile_mask``
    [tiles_y, tiles_x]: 0-tiles are skipped.  ``differentiable`` renders
    through :class:`blend.BlendFunction` (``_render_impl`` :156-163)."""
    feat, bins = _sorted_pass(gaussians, camera["w2c"], camera["K"],
                              camera["campos"], settings, tile_mask)
    return _assemble_outputs(_blend(feat, bins, settings, differentiable),
                             gaussians["normal"], bins.overflow,
                             settings.height, settings.width)


def render_fixed_binning(gaussians: Dict[str, torch.Tensor],
                         order: torch.Tensor, tile_lists: torch.Tensor,
                         tile_counts: torch.Tensor,
                         camera: Dict[str, torch.Tensor],
                         settings: RasterSettings) -> Dict[str, torch.Tensor]:
    """Differentiable render over a FROZEN depth order ``order`` [V] (sorted
    position -> map slot) and tile lists [T, Kt] (sentinel V)
    (``render_fixed_binning`` :426): ``optimize_freeze_binning``'s render.

    Projection, shading and the blend (:class:`blend.BlendFunction`, K1 in
    residual mode, K2 backward) run on the current parameters; the order and
    the tile membership stay those of the call's initial parameters, so the
    depth sort and the binning run once per call instead of once per
    iteration.  A divergence from the reference, which re-sorts every
    iteration; off by default.  Index maps hold map slots; the overflow is
    the binning's, counted once per call, so this reports 0."""
    H, W = settings.height, settings.width
    geo = project_geometry(gaussians["xyz"], gaussians["scales"],
                           gaussians["rotations"], gaussians["alive"],
                           camera["w2c"], camera["K"], W, H,
                           settings.scale_modifier)
    o = order.long()
    P = gaussians["xyz"].shape[0]
    r, g, b, elig = shade_cols(
        gaussians["xyz"][o], gaussians["shs"].reshape(P, -1)[o],
        gaussians["normal"][o], camera["campos"], settings.sh_degree,
        settings.normal_threshold)
    feat = _feature_rows(geo, o, r, g, b, gaussians["opacity"], elig)
    tiles = blend.blend_tiles_fused(
        feat, order, tile_lists, tile_counts,
        binning.tile_origins(H, W, feat.device), settings.opaque_threshold,
        settings.T_threshold)
    return _assemble_outputs(tiles, gaussians["normal"],
                             torch.zeros((), dtype=torch.int32,
                                         device=feat.device), H, W)


def render_transmission(gaussians: Dict[str, torch.Tensor],
                        camera: Dict[str, torch.Tensor],
                        settings: RasterSettings) -> Dict[str, torch.Tensor]:
    """Final-transmittance map only (``render_transmission`` :578): the
    optimize masks' render.  Same projection and binning as :func:`render`;
    the blend carries 6 columns and skips the shade.  Returns {"T_map"
    [H, W, 1], "overflow"}."""
    H, W = settings.height, settings.width
    geo = project_geometry(gaussians["xyz"], gaussians["scales"],
                           gaussians["rotations"], gaussians["alive"],
                           camera["w2c"], camera["K"], W, H,
                           settings.scale_modifier)
    bins = binning.bin_gaussians(geo, H, W, settings.block_capacity,
                                 settings.tile_capacity, settings.max_visible)
    T = blend.blend_transmission(
        transmission_rows(geo, bins.order, gaussians["opacity"]),
        bins.tile_lists, bins.tile_counts,
        binning.tile_origins(H, W, geo.depth.device), settings.T_threshold)
    return {"T_map": _to_image(T[..., None], 1, H, W),
            "overflow": bins.overflow}


def transmission_rows(geo, order: torch.Tensor,
                      opacity: torch.Tensor) -> torch.Tensor:
    """[V+1, 6] transmission blend rows of the sorted entries ``order`` with
    the zero sentinel row V."""
    o = order.long()
    cols = torch.stack([geo.mean2d[o, 0], geo.mean2d[o, 1], geo.conic[o, 0],
                        geo.conic[o, 1], geo.conic[o, 2],
                        opacity.reshape(-1)[o]], dim=-1)
    return torch.cat([cols, cols.new_zeros((1, blend.NTRANS))])


def compact_feature_rows(gaussians_c: Dict[str, torch.Tensor],
                         camera: Dict[str, torch.Tensor],
                         settings: RasterSettings) -> torch.Tensor:
    """[Vc+1, 11] blend rows of :func:`render_compact`'s working set, in
    its own row order, with the zero sentinel row Vc."""
    geo = project_geometry(gaussians_c["xyz"], gaussians_c["scales"],
                           gaussians_c["rotations"], gaussians_c["valid"],
                           camera["w2c"], camera["K"], settings.width,
                           settings.height, settings.scale_modifier)
    r, g, b, elig = shade_cols(gaussians_c["xyz"], gaussians_c["shs_flat"],
                               gaussians_c["normal"], camera["campos"],
                               settings.sh_degree, settings.normal_threshold)
    return _feature_rows(geo, None, r, g, b, gaussians_c["opacity"], elig)


def render_compact(gaussians_c: Dict[str, torch.Tensor],
                   tile_lists_c: torch.Tensor, tile_counts_c: torch.Tensor,
                   camera: Dict[str, torch.Tensor], settings: RasterSettings,
                   tile_rows: torch.Tensor, tile_origins: torch.Tensor,
                   n_tiles_full: int,
                   index: Optional[blend.RowIndex] = None
                   ) -> Dict[str, torch.Tensor]:
    """Differentiable render over a compact working set (``render_compact``
    :483): the optimize loop's render.

    ``gaussians_c``: the optimized pool's activated rows xyz [Vc,3], scales,
    rotations, opacity [Vc,1], shs_flat [Vc,3K], normal [Vc,3], valid [Vc]
    bool.  ``tile_lists_c`` [Tc, Ktc] index those rows (sentinel Vc) for the
    ``Tc`` grid tiles ``tile_rows`` whose pixel origins are ``tile_origins``;
    their outputs scatter back into the full ``n_tiles_full`` grid, where
    every other tile keeps the zero-trip values (T 1, indices -1), exactly
    what the full-grid blend gives a count-0 tile.  Index maps hold
    compact row indices.  ``index``: the lists' :func:`blend.row_index`,
    which the backward's reduce kernel reads (on CUDA, built per backward
    when None)."""
    H, W = settings.height, settings.width
    feat = compact_feature_rows(gaussians_c, camera, settings)
    ident = torch.arange(feat.shape[0] - 1, dtype=torch.int32,
                         device=feat.device)
    tiles = blend.blend_tiles_fused(
        feat, ident, tile_lists_c, tile_counts_c, tile_origins,
        settings.opaque_threshold, settings.T_threshold, index)
    rows = tile_rows.long()

    def put(fill, x):
        full = x.new_full((n_tiles_full,) + x.shape[1:], fill)
        return full.index_copy(0, rows, x)

    tiles = blend.TileOutputs(
        color=put(0.0, tiles.color), depth=put(0.0, tiles.depth),
        depth_index=put(-1, tiles.depth_index),
        color_index=put(-1, tiles.color_index),
        depth_weight=put(0.0, tiles.depth_weight),
        color_weight=put(0.0, tiles.color_weight),
        T_final=put(1.0, tiles.T_final))
    return _assemble_outputs(tiles, gaussians_c["normal"],
                             torch.zeros((), dtype=torch.int32,
                                         device=feat.device), H, W)


def render_model_and_stable(gaussians: Dict[str, torch.Tensor],
                            stable: torch.Tensor,
                            camera: Dict[str, torch.Tensor],
                            settings: RasterSettings):
    """Model (alive-pool) render plus the stable pool's color index map from
    ONE projection / sort / binning / shade pass (``render_model_and_stable``
    :267): the second K1 launch reuses the tile lists with the opacity and
    eligibility of non-stable entries zeroed (``FeatCols.mask_contribution``
    — a zero-alpha entry is blend-invisible on every output).  Capacities
    bound the alive population, so this equals a standalone stable render
    while overflow is 0.

    Returns (model_out, stable_color_index [H, W] int32)."""
    H, W = settings.height, settings.width
    feat, bins = _sorted_pass(gaussians, camera["w2c"], camera["K"],
                              camera["campos"], settings)
    model_out = _assemble_outputs(_blend(feat, bins, settings),
                                  gaussians["normal"], bins.overflow, H, W)
    keep = torch.cat([stable[bins.order.long()].to(torch.float32),
                      feat.new_zeros((1,))])
    feat_stable = feat.clone()
    feat_stable[:, 9:11] *= keep[:, None]
    stable_tiles = _blend(feat_stable, bins, settings)
    stable_cidx = _to_image(stable_tiles.color_index[..., None], 1, H, W)[..., 0]
    return model_out, stable_cidx


def render_with_inserted(gaussians: Dict[str, torch.Tensor],
                         camera: Dict[str, torch.Tensor],
                         settings: RasterSettings) -> Dict[str, torch.Tensor]:
    """The post-spawn lifecycle render (``render_with_inserted`` :332).

    The JAX version merges the just-inserted rows into the spawn render's
    carried depth order; this is a fresh full render of the post-insert
    state instead.  The two are exact equals while overflow is 0 and no
    depth ties fall between an old and a new gaussian
    (``tests/test_rasterizer.py::test_render_with_inserted_matches_fresh``)."""
    return render(gaussians, camera, settings)
