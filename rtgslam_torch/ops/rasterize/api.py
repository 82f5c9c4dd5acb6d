"""Renderer API: port of ``rtgslam_tpu/ops/rasterize/api.py`` (inference).

``render`` returns, in [H, W, C] layout: render, depth, normal,
color_index_map, depth_index_map, color_hit_weight, depth_hit_weight,
T_map and the bin overflow count.  Index maps hold map slot indices
(-1 = no hit).  Every blend goes through :func:`blend.blend_tiles`, which
launches kernel K1 for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

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


def _sorted_pass(gaussians: Dict[str, torch.Tensor], w2c, K, campos,
                 settings: RasterSettings):
    """Project, depth-sort, bin and shade: everything before the blend.

    Returns (feat [V+1, 11] depth-sorted feature rows with the zero sentinel
    row V, Binning)."""
    H, W = settings.height, settings.width
    geo = project_geometry(gaussians["xyz"], gaussians["scales"],
                           gaussians["rotations"], gaussians["alive"],
                           w2c, K, W, H, settings.scale_modifier)
    bins = binning.bin_gaussians(geo, H, W, settings.block_capacity,
                                 settings.tile_capacity, settings.max_visible)
    o = bins.order.long()
    P = gaussians["xyz"].shape[0]
    r, g, b, elig = shade_cols(
        gaussians["xyz"][o], gaussians["shs"].reshape(P, -1)[o],
        gaussians["normal"][o], campos, settings.sh_degree,
        settings.normal_threshold)
    feat = torch.stack([
        geo.mean2d[o, 0], geo.mean2d[o, 1], geo.conic[o, 0], geo.conic[o, 1],
        geo.conic[o, 2], geo.depth[o], r, g, b,
        gaussians["opacity"].reshape(-1)[o], elig.to(torch.float32)], dim=-1)
    feat = torch.cat([feat, feat.new_zeros((1, blend.NFEAT))])
    return feat, bins


def _blend(feat, bins, settings: RasterSettings) -> blend.TileOutputs:
    return blend.blend_tiles(
        feat, bins.order, bins.tile_lists, bins.tile_counts,
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
    normal_pad = torch.cat([normals, normals.new_zeros((1, 3))])
    normal = torch.where((depth_index >= 0)[..., None],
                         normal_pad[depth_index.clamp(min=0).long()], 0.0)
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
           settings: RasterSettings) -> Dict[str, torch.Tensor]:
    """Render the map from a camera (``render`` :623, inference).

    ``gaussians``: activated xyz [P,3], scales [P,3], rotations [P,4],
    opacity [P,1], shs [P,K,3], normal [P,3], alive [P] bool.
    ``camera``: w2c [4,4], K [3,3], campos [3] tensors."""
    feat, bins = _sorted_pass(gaussians, camera["w2c"], camera["K"],
                              camera["campos"], settings)
    return _assemble_outputs(_blend(feat, bins, settings), gaussians["normal"],
                             bins.overflow, settings.height, settings.width)


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
