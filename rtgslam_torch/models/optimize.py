"""Gaussian-map gradient optimization: render -> loss -> gradient -> Adam.

Port of ``rtgslam_tpu/models/optimize.py`` (reference ``local_optimize``
mapper.py:143-210 / ``global_optimization`` mapper.py:594-712).  Each
iteration renders through :class:`..ops.rasterize.blend.BlendFunction` (the
blend kernel K1 forward, the backward kernel K2), takes the gradient with
``torch.autograd.grad`` and applies a masked Adam step written out by hand.

Loss semantics (``loss_update``, mapper.py:371-469):
  * masked L1 color over the frame's render mask;
  * masked L1 depth where the opaque-depth hit exists, gt depth > 0 and the
    signed error is below the spawn threshold;
  * cosine normal loss;
  * "attach" anchor: gaussians whose pre-optimization opacity < 0.9 are
    pulled toward their snapshot xyz / scaling / rotation with weight 1000.

Adam matches ``torch.optim.Adam(eps=1e-15)`` with per-group learning rates,
a fresh state per call and updates masked to the optimized pool (unstable
rows for local passes, stable rows for global ones).

Two formulations, as in the JAX package:
  * :func:`optimize_prepare` + :func:`optimize_execute` (``optimize_compact``,
    the configured default): masks and ONE binning pass per frame, then the
    loop over the optimized pool's rows and the live tiles only — the
    depth order and tile lists stay frozen for the call;
  * :func:`optimize_chain` -> :func:`run_optimize`: every iteration projects,
    sorts and bins the whole map again (the final global pass), or, with
    ``optimize_freeze_binning``, projects every iteration over a depth
    order and tile lists frozen once per call (``render_fixed_binning``).

The JAX package buckets the compact sizes to powers of two for its static
shapes; here the pool and tile counts are used as they are, and the list
crop keeps the chunk boundaries (:func:`list_crop`).  The map state is
updated in place.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from ..ops import preprocess
from ..ops.rasterize import binning
from ..ops.rasterize.api import (RasterSettings, render, render_compact,
                                 render_fixed_binning, render_transmission,
                                 transmission_rows)
from ..ops.rasterize.blend import CHUNK, RowIndex, blend_transmission, row_index
from ..ops.rasterize.project import project_geometry
from ..ops.segment import stable_partition_order
from ..utils.geometry import normalize
from . import map_ops
from .gaussian_map import (MapState, activated_opacity, activated_scales,
                           alive_mask, derived_normal, render_inputs,
                           shs_from_features, stable_mask, unstable_mask)
from .losses import masked_mean

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15

PARAM_KEYS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity")
REPORT_KEYS = ("total", "color", "depth", "normal", "attach")


class Prepared(NamedTuple):
    """What :func:`optimize_prepare` hands to :func:`optimize_execute`."""

    rmasks: torch.Tensor      # [F, H, W] bool loss pixels
    tiles: torch.Tensor       # [F, ty, tx] int32 tile masks
    lists_orig: torch.Tensor  # [F, T, Kt] int32 map slots (sentinel capacity)
    counts: torch.Tensor      # [F, T] int32
    pool_order: torch.Tensor  # [P] int32 optimized pool's slots first
    tile_order: torch.Tensor  # [F, T] int32 live tiles first, per frame
    n_pool: int
    cnt_max: int              # longest tile list
    n_live_tiles: int         # most live tiles of any frame


def list_crop(cnt_max: int, Kt: int) -> int:
    """The tile-list length the compact loop keeps: every entry of every
    list, cut where the blend's chunk boundaries (min(128, length)) stay
    those of the full length — the longest list itself up to 128 entries,
    else rounded up to a multiple of 128."""
    if cnt_max <= CHUNK:
        return max(min(cnt_max, Kt), 1)
    return min(-(-cnt_max // CHUNK) * CHUNK, Kt)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _image_losses(out, frame, hyper):
    """Masked color / depth / normal losses of one rendered frame
    (``_image_losses`` :60)."""
    rmask = frame["render_mask"]
    color_loss = masked_mean(
        torch.sum(torch.abs(out["render"] - frame["color"]), dim=-1) / 3.0,
        rmask)

    depth_err = out["depth"][..., 0] - frame["depth"]
    dmask = ((out["depth_index_map"] >= 0) & (frame["depth"] > 0)
             & (depth_err < hyper["add_depth_thres"]) & rmask)
    depth_loss = masked_mean(torch.abs(depth_err), dmask)

    gt_normal = frame["normal"]
    cos = torch.sum(out["normal"] * gt_normal, dim=-1) / (
        torch.linalg.norm(out["normal"], dim=-1)
        * torch.linalg.norm(gt_normal, dim=-1) + 1e-8)
    nmask = (rmask & (out["depth_index_map"] >= 0)
             & torch.any(gt_normal != 0, dim=-1))
    normal_loss = masked_mean(1.0 - cos, nmask)
    return color_loss, depth_loss, normal_loss


def _attach_loss(params, update_mask, hyper):
    """Anchor low-opacity gaussians to their pre-optimization snapshot
    (``_attach_loss`` :87, weight 1000, mapper.py:445-453)."""
    attach_rows = (activated_opacity(hyper["hist_opacity"])[:, 0] < 0.9) \
        & update_mask

    def row_l2(a, b):
        per_row = torch.mean(((a - b) ** 2).reshape(a.shape[0], -1), dim=-1)
        return masked_mean(per_row, attach_rows)

    return 1000.0 * (row_l2(params["scaling"], hyper["hist_scaling"])
                     + row_l2(params["xyz"], hyper["hist_xyz"])
                     + row_l2(params["rotation"], hyper["hist_rotation_raw"]))


def _total(out, frame, params, update_mask, hyper):
    color_loss, depth_loss, normal_loss = _image_losses(out, frame, hyper)
    attach_loss = _attach_loss(params, update_mask, hyper)
    total = (hyper["color_weight"] * color_loss
             + hyper["depth_weight"] * depth_loss
             + hyper["normal_weight"] * normal_loss)
    report = {"total": total, "color": color_loss, "depth": depth_loss,
              "normal": normal_loss, "attach": attach_loss}
    return total + attach_loss, report


def _loss_fn(params, aux, frame, settings: RasterSettings, hyper):
    """Loss of a render of the pool ``aux["render_alive"]`` (``_loss_fn``
    :104): projection, depth sort and binning run again every call, unless
    the frame carries frozen bins (``bin_order``, ``bin_tile_lists``,
    ``bin_tile_counts``: :func:`render_fixed_binning`, :115-121)."""
    gauss = {
        "xyz": params["xyz"],
        "scales": activated_scales(params["scaling"]),
        "rotations": normalize(params["rotation"]),
        "opacity": activated_opacity(params["opacity"]),
        "shs": shs_from_features(params["features_dc"], params["features_rest"]),
        "normal": derived_normal(params["scaling"], params["rotation"]),
        "alive": aux["render_alive"],
    }
    if "bin_order" in frame:
        out = render_fixed_binning(gauss, frame["bin_order"],
                                   frame["bin_tile_lists"],
                                   frame["bin_tile_counts"], frame, settings)
    else:
        out = render(gauss, frame, settings, tile_mask=frame["tile_mask"],
                     differentiable=True)
    return _total(out, frame, params, aux["update_mask"], hyper)


def compact_gaussians(params_c, row_valid) -> Dict[str, torch.Tensor]:
    """The activated arrays :func:`render_compact` takes, from raw rows."""
    Ac = params_c["xyz"].shape[0]
    return {
        "xyz": params_c["xyz"],
        "scales": activated_scales(params_c["scaling"]),
        "rotations": normalize(params_c["rotation"]),
        "opacity": activated_opacity(params_c["opacity"]),
        "shs_flat": shs_from_features(params_c["features_dc"],
                                      params_c["features_rest"]).reshape(Ac, -1),
        "normal": derived_normal(params_c["scaling"], params_c["rotation"]),
        "valid": row_valid,
    }


def _loss_fn_compact(params_c, aux, frame, settings: RasterSettings, hyper):
    """:func:`_loss_fn` over the pool-compact rows with frozen tile lists
    (``_loss_fn_compact`` :138)."""
    gauss_c = compact_gaussians(params_c, aux["row_valid"])
    index = (RowIndex(frame["row_ptr_c"], frame["pos_c"])
             if "row_ptr_c" in frame else None)
    out = render_compact(gauss_c, frame["tile_lists_c"], frame["tile_counts_c"],
                         frame, settings, frame["tile_rows"],
                         frame["tile_origins"], frame["n_tiles_full"], index)
    return _total(out, frame, params_c, aux["update_mask"], hyper)


# ---------------------------------------------------------------------------
# Adam and the loop
# ---------------------------------------------------------------------------

@torch.no_grad()
def _adam_step(params, grads, m, v, step: int, lrs, update_mask):
    """One masked Adam step at 0-based iteration ``step`` (``_adam_step``
    :179): bias correction at t = step + 1, eps 1e-15, rows outside
    ``update_mask`` neither see their gradient nor move.  Returns new
    (params, m, v) dicts."""
    # float32 bias corrections, taken on the host: no device round trip
    t = np.float32(step + 1)
    c1 = float(np.float32(1) - np.float32(ADAM_B1) ** t)
    c2 = float(np.float32(1) - np.float32(ADAM_B2) ** t)
    new_params, new_m, new_v = {}, {}, {}
    for k in PARAM_KEYS:
        mask = update_mask.reshape((-1,) + (1,) * (grads[k].ndim - 1))
        g = torch.where(mask, grads[k], 0.0)
        m_k = ADAM_B1 * m[k] + (1 - ADAM_B1) * g
        v_k = ADAM_B2 * v[k] + (1 - ADAM_B2) * g * g
        update = lrs[k] * (m_k / c1) / (torch.sqrt(v_k / c2) + ADAM_EPS)
        new_params[k] = params[k] - torch.where(mask, update, 0.0)
        new_m[k], new_v[k] = m_k, v_k
    return new_params, new_m, new_v


def _iterate(params, confidence, loss_fn, frame_of, frame_seq, n_iters: int,
             lrs, update_mask):
    """The render -> loss -> gradient -> Adam -> confidence loop shared by
    both formulations (``run_optimize`` :220-242).  Returns (params,
    confidence, the last iteration's report)."""
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    m, v = zeros, {k: z.clone() for k, z in zeros.items()}
    report = {k: torch.zeros((), device=confidence.device) for k in REPORT_KEYS}
    for i in range(n_iters):
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        with torch.enable_grad():
            loss, report = loss_fn(leaves, frame_of(int(frame_seq[i])))
            grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_KEYS],
                                        allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(PARAM_KEYS, grads)}
        params, m, v = _adam_step(leaves, grads, m, v, i, lrs, update_mask)
        touched = torch.any(grads["features_dc"] != 0, dim=-1) & update_mask
        confidence = confidence + touched[:, None].to(confidence.dtype)
        report = {k: x.detach() for k, x in report.items()}
    return params, confidence, report


def run_optimize(state: MapState, frames: Dict[str, torch.Tensor],
                 frame_seq: Sequence[int], n_iters: int,
                 render_alive: torch.Tensor, update_mask: torch.Tensor,
                 lrs, hyper, settings: RasterSettings):
    """The loop over full renders (``run_optimize`` :197).  ``frames``
    holds stacked color, depth, normal, w2c, K, campos, render_mask and
    tile_mask [F, ...], and with frozen binning bin_order [F, V],
    bin_tile_lists [F, T, Kt] and bin_tile_counts [F, T] (the JAX
    ``frozen_bins``); ``frame_seq`` the frame of every iteration.  Updates
    ``state``'s parameters and confidence; returns the report."""
    aux = {"render_alive": render_alive, "update_mask": update_mask}
    params = {k: getattr(state, k) for k in PARAM_KEYS}
    params, confidence, report = _iterate(
        params, state.confidence,
        lambda p, frame: _loss_fn(p, aux, frame, settings, hyper),
        lambda f: {k: x[f] for k, x in frames.items()},
        frame_seq, n_iters, lrs, update_mask)
    with torch.no_grad():
        for k in PARAM_KEYS:
            getattr(state, k).copy_(params[k])
        state.confidence.copy_(confidence)
    return report


# ---------------------------------------------------------------------------
# masks and the compact formulation
# ---------------------------------------------------------------------------

@torch.no_grad()
def _make_masks(state: MapState, colors, w2cs, Ks, camposes,
                settings: RasterSettings, mode: str, sample_ratio: float):
    """Per-frame partial-render masks (``_make_masks_impl`` :251, reference
    ``evaluate_render_range`` mapper.py:471-508).  Returns (rmasks [F,H,W]
    bool, tiles [F,ty,tx] int32)."""
    H, W = settings.height, settings.width
    local = mode == "local"
    mask_gauss = render_inputs(
        state, unstable_mask(state) if local else stable_mask(state))
    rmasks, tiles = [], []
    for f in range(w2cs.shape[0]):
        cam = {"w2c": w2cs[f], "K": Ks[f], "campos": camposes[f]}
        if sample_ratio > 0 and not local:
            out = render(mask_gauss, cam, settings)
            err = torch.sum(torch.abs(out["render"] - colors[f]), dim=-1)
            err = torch.where(torch.sum(out["render"], dim=-1) == 0, 0.0, err)
            tile = preprocess.colorerror_to_tilemask(err, 16, sample_ratio)
            rmask = preprocess.tilemask_to_pixelmask(tile, H, W)
        else:
            T = render_transmission(mask_gauss, cam, settings)["T_map"][..., 0]
            # not intersected with the tile mask (reference parity, :281-286)
            rmask = T != 1.0
            if local:
                tile = preprocess.transmission_to_tilemask(rmask, 16, 0.5)
            else:
                ty, tx = binning.tile_grid_shape(H, W)
                tile = torch.ones((ty, tx), dtype=torch.int32,
                                  device=rmask.device)
        rmasks.append(rmask)
        tiles.append(tile)
    return torch.stack(rmasks), torch.stack(tiles)


@torch.no_grad()
def optimize_prepare(state: MapState, colors, depths, normals, w2cs, Ks,
                     camposes, settings: RasterSettings, mode: str,
                     sample_ratio: float,
                     mask_depth_positive: bool) -> Prepared:
    """Stage 1 of the compact path (``optimize_prepare`` :298): per-frame
    masks and one frozen binning pass per frame.

    LOCAL mode shares one projection / depth sort / binning per frame between
    the mask and the frozen lists: the mask is the unstable pool's
    transmission, taken over the alive pass's lists with the opacity of every
    other row zeroed (a zero-alpha entry is blend-invisible), and the
    >= 50 %-coverage tile mask then zeroes the counts of the other tiles.
    GLOBAL mode renders the stable pool's masks first and bins under them."""
    H, W = settings.height, settings.width
    P = state.capacity
    dev = state.xyz.device
    local = mode == "local"
    pool_full = alive_mask(state) if local else stable_mask(state)
    pool_order = stable_partition_order(pool_full)
    n_pool = int(pool_full.sum())
    V = min(settings.max_visible, P)
    origins = binning.tile_origins(H, W, dev)
    slot_sentinel = torch.full((1,), P, dtype=torch.int32, device=dev)
    F = w2cs.shape[0]

    if local:
        rmasks, tiles = [], []
        mask_opacity = (activated_opacity(state.opacity)
                        * unstable_mask(state)[:, None].to(torch.float32))
        scales, rots = activated_scales(state.scaling), normalize(state.rotation)
    else:
        rmasks, tiles = _make_masks(state, colors, w2cs, Ks, camposes,
                                    settings, mode, sample_ratio)
        gauss0 = render_inputs(state, pool_full)
        scales, rots = gauss0["scales"], gauss0["rotations"]
    lists_orig, counts = [], []
    for f in range(F):
        geo = project_geometry(state.xyz, scales, rots, pool_full, w2cs[f],
                               Ks[f], W, H, settings.scale_modifier)
        if local:
            bins = binning.bin_gaussians(geo, H, W, settings.block_capacity,
                                         settings.tile_capacity, V)
            T = blend_transmission(
                transmission_rows(geo, bins.order, mask_opacity),
                bins.tile_lists, bins.tile_counts, origins,
                settings.T_threshold)
            rmask = binning.scatter_tiles(T[..., None], H, W)[..., 0] != 1.0
            tile = preprocess.transmission_to_tilemask(rmask, 16, 0.5)
            cnt = torch.where(binning.tile_mask_flat(tile, H, W) > 0,
                              bins.tile_counts, 0)
            rmasks.append(rmask)
            tiles.append(tile)
        else:
            bins = binning.bin_gaussians(geo, H, W, settings.block_capacity,
                                         settings.tile_capacity, V,
                                         tile_mask=tiles[f])
            cnt = bins.tile_counts
        order_pad = torch.cat([bins.order, slot_sentinel])
        lists_orig.append(order_pad[bins.tile_lists.long()])
        counts.append(cnt)
    if local:
        rmasks, tiles = torch.stack(rmasks), torch.stack(tiles)
    if mask_depth_positive:
        rmasks = rmasks & (depths > 0)
    counts = torch.stack(counts)
    tile_order = torch.stack([stable_partition_order(c > 0) for c in counts])
    return Prepared(
        rmasks=rmasks, tiles=tiles, lists_orig=torch.stack(lists_orig),
        counts=counts, pool_order=pool_order, tile_order=tile_order,
        n_pool=n_pool, cnt_max=int(counts.max()),
        n_live_tiles=int((counts > 0).sum(dim=1).max()))


class Compact(NamedTuple):
    """The optimize loop's compact working set (``optimize_execute``
    :503-544): the optimized pool's rows and the live tiles' lists in that
    row space."""

    rows: torch.Tensor       # [Ac] map slots
    row_valid: torch.Tensor  # [Ac] bool: the first n_pool rows
    params: Dict[str, torch.Tensor]   # [Ac, ...] raw parameters
    update: torch.Tensor     # [Ac] bool rows Adam moves
    hyper: Dict[str, torch.Tensor]    # loss weights + [Ac] history rows
    frames: Dict[str, torch.Tensor]   # stacked per-frame inputs [F, ...]


def compact_problem(state: MapState, colors, depths, normals, w2cs, Ks,
                    camposes, rmasks, lists_orig, counts,
                    pool_rows: torch.Tensor, n_pool: int,
                    tile_rows: torch.Tensor, weights, hist,
                    settings: RasterSettings, mode: str, Ktc: int) -> Compact:
    """Gather the pool rows ``pool_rows`` ([Ac] slots, the first ``n_pool``
    valid) and remap the tile lists of the live-first tiles ``tile_rows``
    [F, Tc], cropped to ``Ktc`` (:func:`list_crop`), into that row space
    (sentinel Ac)."""
    P = state.capacity
    dev = state.xyz.device
    update_full = unstable_mask(state) if mode == "local" else stable_mask(state)
    rows = pool_rows.long()
    Ac = rows.shape[0]
    row_valid = torch.arange(Ac, device=dev) < n_pool
    hyper = dict(weights, hist_opacity=hist["opacity"][rows],
                 hist_scaling=hist["scaling"][rows],
                 hist_xyz=hist["xyz"][rows],
                 hist_rotation_raw=hist["rotation_raw"][rows])
    # map slot (sentinel P) -> compact row (sentinel Ac)
    inv = torch.full((P + 1,), Ac, dtype=torch.int32, device=dev)
    inv[torch.where(row_valid, rows, P)] = torch.arange(
        Ac, dtype=torch.int32, device=dev)
    inv[P] = Ac
    lists_a = inv[lists_orig[:, :, :Ktc].long()]
    trows = tile_rows.long()
    lists_c = torch.gather(
        lists_a, 1, trows[:, :, None].expand(-1, -1, lists_a.shape[2]))
    counts_c = torch.gather(torch.clamp(counts, max=Ktc), 1, trows)
    frames = {
        "color": colors, "depth": depths, "normal": normals, "w2c": w2cs,
        "K": Ks, "campos": camposes, "render_mask": rmasks,
        "tile_lists_c": lists_c, "tile_counts_c": counts_c,
        "tile_rows": trows,
        "tile_origins": binning.tile_origins(settings.height, settings.width,
                                             dev)[trows],
    }
    if dev.type == "cuda":
        # the reduce kernel's CSR inverse index of the frozen lists, once per
        # call (the CPU backward needs none)
        index = [row_index(lists_c[f], counts_c[f], Ac)
                 for f in range(lists_c.shape[0])]
        frames["row_ptr_c"] = torch.stack([ix.row_ptr for ix in index])
        frames["pos_c"] = torch.stack([ix.pos for ix in index])
    return Compact(rows=rows, row_valid=row_valid,
                   params={k: getattr(state, k)[rows] for k in PARAM_KEYS},
                   update=update_full[rows] & row_valid, hyper=hyper,
                   frames=frames)


def optimize_execute(state: MapState, colors, depths, normals, w2cs, Ks,
                     camposes, rmasks, lists_orig, counts,
                     pool_rows: torch.Tensor, n_pool: int,
                     tile_rows: torch.Tensor, frame_seq: Sequence[int],
                     n_iters: int, lrs, weights, settings: RasterSettings,
                     mode: str, max_weight: float, Ktc: int):
    """Stage 2 of the compact path (``optimize_execute`` :450): the loop
    over the :func:`compact_problem` of the pool rows ``pool_rows`` and the
    live-first tiles ``tile_rows``, then the local history merge.  Updates
    ``state``; returns the last report."""
    hist = map_ops.capture_history(state)
    cp = compact_problem(state, colors, depths, normals, w2cs, Ks, camposes,
                         rmasks, lists_orig, counts, pool_rows, n_pool,
                         tile_rows, weights, hist, settings, mode, Ktc)
    aux = {"update_mask": cp.update, "row_valid": cp.row_valid}
    n_tiles_full = counts.shape[1]

    def frame_of(f):
        return dict({k: x[f] for k, x in cp.frames.items()},
                    n_tiles_full=n_tiles_full)

    params_c, conf_c, report = _iterate(
        cp.params, state.confidence[cp.rows],
        lambda p, frame: _loss_fn_compact(p, aux, frame, settings, cp.hyper),
        frame_of, frame_seq, n_iters, lrs, cp.update)

    # ---- scatter the valid rows back into the map ---------------------------
    with torch.no_grad():
        keep = cp.rows[cp.row_valid]
        for k in PARAM_KEYS:
            getattr(state, k)[keep] = params_c[k][cp.row_valid]
        state.confidence[keep] = conf_c[cp.row_valid]
        if mode == "local":
            map_ops.history_merge(state, hist, max_weight, unstable_mask(state))
    return report


@torch.no_grad()
def _frozen_bins(state: MapState, render_alive, w2cs, Ks, tiles,
                 settings: RasterSettings):
    """One depth sort and binning per frame from the current parameters of
    the pool ``render_alive``, under the frame's tile mask (``optimize_chain``
    :641-665).  Returns stacked (order [F, V], tile_lists [F, T, Kt],
    tile_counts [F, T])."""
    H, W = settings.height, settings.width
    gauss0 = render_inputs(state, render_alive)
    bins = [binning.bin_gaussians(
        project_geometry(gauss0["xyz"], gauss0["scales"], gauss0["rotations"],
                         gauss0["alive"], w2cs[f], Ks[f], W, H,
                         settings.scale_modifier),
        H, W, settings.block_capacity, settings.tile_capacity,
        settings.max_visible, tile_mask=tiles[f]) for f in range(w2cs.shape[0])]
    return (torch.stack([b.order for b in bins]),
            torch.stack([b.tile_lists for b in bins]),
            torch.stack([b.tile_counts for b in bins]))


def optimize_chain(state: MapState, colors, depths, normals, w2cs, Ks,
                   camposes, frame_seq: Sequence[int], n_iters: int, lrs,
                   weights, settings: RasterSettings, mode: str,
                   sample_ratio: float, mask_depth_positive: bool,
                   max_weight: float, freeze_binning: bool = False):
    """A whole local or global pass over full renders (``optimize_chain``
    :588): history snapshot, masks, the loop, and in local mode the history
    merge.  With ``freeze_binning`` each frame is depth-sorted and binned
    once, from the call's initial parameters under its tile mask
    (:641-665), and every iteration renders through those frozen bins.
    Updates ``state``; returns the last report."""
    local = mode == "local"
    render_alive = alive_mask(state) if local else stable_mask(state)
    update_mask = unstable_mask(state) if local else stable_mask(state)
    hist = map_ops.capture_history(state)
    hyper = dict(weights, hist_opacity=hist["opacity"],
                 hist_scaling=hist["scaling"], hist_xyz=hist["xyz"],
                 hist_rotation_raw=hist["rotation_raw"])
    rmasks, tiles = _make_masks(state, colors, w2cs, Ks, camposes, settings,
                                mode, sample_ratio)
    if mask_depth_positive:
        rmasks = rmasks & (depths > 0)
    frames = {"color": colors, "depth": depths, "normal": normals,
              "w2c": w2cs, "K": Ks, "campos": camposes,
              "render_mask": rmasks, "tile_mask": tiles}
    if freeze_binning:
        frames.update(zip(("bin_order", "bin_tile_lists", "bin_tile_counts"),
                          _frozen_bins(state, render_alive, w2cs, Ks, tiles,
                                       settings)))
    report = run_optimize(state, frames, frame_seq, n_iters, render_alive,
                          update_mask, lrs, hyper, settings)
    if local:
        map_ops.history_merge(state, hist, max_weight, unstable_mask(state))
    return report
