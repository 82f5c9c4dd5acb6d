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

On a CUDA device a compact pass replays the parts of its iteration around
K1, K2 and Adam as CUDA graphs (:class:`CompactStages`, captured through
``utils/cuda_graphs.py``), with the same bits as the eager iteration.

The JAX package buckets the compact sizes to powers of two for its static
shapes; here the pool and tile counts are used as they are, and the list
crop keeps the chunk boundaries (:func:`list_crop`).  The map state is
updated in place.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from ..ops import preprocess
from ..ops.rasterize import binning, blend
from ..ops.rasterize.api import (RasterSettings, compact_feature_rows,
                                 compact_outputs, render, render_compact,
                                 render_fixed_binning, render_transmission,
                                 transmission_rows)
from ..ops.rasterize.blend import CHUNK, RowIndex, blend_transmission, row_index
from ..ops.rasterize.project import project_geometry
from ..ops.segment import stable_partition_order
from ..utils import cuda_graphs, perf
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


def _image_total(out, frame, hyper):
    """The weighted image losses of a render and the report without the
    attach term."""
    color_loss, depth_loss, normal_loss = _image_losses(out, frame, hyper)
    total = (hyper["color_weight"] * color_loss
             + hyper["depth_weight"] * depth_loss
             + hyper["normal_weight"] * normal_loss)
    return total, {"total": total, "color": color_loss, "depth": depth_loss,
                   "normal": normal_loss}


def _total(out, frame, params, update_mask, hyper):
    total, report = _image_total(out, frame, hyper)
    report["attach"] = _attach_loss(params, update_mask, hyper)
    return total + report["attach"], report


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
                         frame["tile_origins"], frame["n_tiles_full"], index,
                         frame.get("blend_fn"))
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


def loss_grads(loss_fn, params):
    """(d loss / d each parameter group, the detached report) of
    ``loss_fn`` at ``params``; zeros for a group the loss does not reach."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss, report = loss_fn(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in PARAM_KEYS],
                                    allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(PARAM_KEYS, grads)}
    return grads, {k: x.detach() for k, x in report.items()}


def bump_confidence(confidence, grads, update_mask):
    """One more optimization for every updated row that the iteration's
    colour gradient reached (``run_optimize`` :238-240)."""
    touched = torch.any(grads["features_dc"] != 0, dim=-1) & update_mask
    return confidence + touched[:, None].to(confidence.dtype)


def _iterate(params, confidence, loss_fn, frame_of, frame_seq, n_iters: int,
             lrs, update_mask, stages=None):
    """The render -> loss -> gradient -> Adam -> confidence loop shared by
    both formulations (``run_optimize`` :220-242).  ``stages``, a compact
    pass's :class:`CompactStages`, takes the gradient in place of
    :func:`loss_grads` over ``loss_fn``.  Returns (params, confidence, the
    last iteration's report)."""
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    m, v = zeros, {k: z.clone() for k, z in zeros.items()}
    report = {k: torch.zeros((), device=confidence.device) for k in REPORT_KEYS}
    for i in range(n_iters):
        with perf.span("optimize.iter"):
            f = int(frame_seq[i])
            if stages is None:
                frame = frame_of(f)
                grads, report = loss_grads(lambda p: loss_fn(p, frame),
                                           params)
            else:
                grads, report = stages(i, f, params)
            params, m, v = _adam_step(params, grads, m, v, i, lrs,
                                      update_mask)
            confidence = bump_confidence(confidence, grads, update_mask)
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
    with perf.span("optimize.size_fetch"):
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
    with perf.span("optimize.size_fetch"):
        cnt_max = int(counts.max())
        n_live_tiles = int((counts > 0).sum(dim=1).max())
    return Prepared(
        rmasks=rmasks, tiles=tiles, lists_orig=torch.stack(lists_orig),
        counts=counts, pool_order=pool_order, tile_order=tile_order,
        n_pool=n_pool, cnt_max=cnt_max, n_live_tiles=n_live_tiles)


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
    with perf.span("optimize.constant_upload"):   # a host scalar
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


# A compact pass of at least this many iterations replays its stages as
# CUDA graphs; a shorter one runs eager.  On an H100 at 480x640 a capture
# took 27-44 ms, an eager iteration ~30 ms and a replayed one ~6 ms, so the
# capture pays for itself within a few iterations (PERF.md §6).
REPLAY_MIN_ITERS = 10


def use_stages(device: torch.device, n_iters: int, blend_for) -> bool:
    """Whether a compact pass replays its stages as CUDA graphs
    (:class:`CompactStages`): on a CUDA device, with the one-device blend,
    and from :data:`REPLAY_MIN_ITERS` iterations on."""
    return (device.type == "cuda" and blend_for is None
            and n_iters >= REPLAY_MIN_ITERS)


class _Seed(torch.autograd.Function):
    """``_Seed.apply(*outputs, *cotangents)``: a scalar whose gradient
    hands each output its cotangent as given, so ``autograd.grad`` of it is
    ``autograd.grad(outputs, inputs, cotangents)`` without that form's size
    check, which imports torch's symbolic-shape module once a process
    (4.5-7 s on the H100 host of PERF.md §6)."""

    @staticmethod
    def forward(ctx, *pairs):
        ctx.save_for_backward(*pairs[len(pairs) // 2:])
        return pairs[0].new_empty(())

    @staticmethod
    def backward(ctx, _):
        cots = ctx.saved_tensors
        return (*cots, *(None,) * len(cots))


def _seeded_grad(outputs, inputs, cotangents):
    """``autograd.grad(outputs, inputs, cotangents)`` through :class:`_Seed`;
    None for an input the outputs do not reach."""
    return torch.autograd.grad(_Seed.apply(*outputs, *cotangents), inputs,
                               allow_unused=True)


class CompactStages:
    """A compact pass's gradient in five steps, for :func:`_iterate`:

    1. stage A: the pool's raw rows to the blend rows, the derived normals
       the render's normal map reads, and the attach loss;
    2. K1 (:func:`blend.blend_tiles_fused`) on stage A's rows;
    3. stage C: the tile outputs into the image, the image losses and their
       cotangents, forward and backward;
    4. K2, reached through autograd on K1's outputs
       (``BlendFunction.backward`` calls ``blend.blend_bwd``);
    5. stage A's backward, fed K2's row gradient and stage C's cotangents.

    Bitwise :func:`loss_grads` over :func:`_loss_fn_compact`: each stage runs
    the same operations, and autograd runs a graph's nodes newest first,
    so each parameter's gradient terms add up in the same order as in the
    whole iteration's graph, where the attach loss is made last and its
    terms come first.  Stage A makes the attach loss last too, and its
    backward is one ``autograd.grad`` over all of its outputs.

    The stages read fixed tensors that each step copies its values into:
    the parameters, the frame's index into the pass's stacked frames, K1's
    outputs and K2's row gradient.  On CUDA the second step captures stages
    A, C and A's backward as three CUDA graphs in one memory pool (span
    ``optimize.capture``) and that step and every later one replay them
    (span ``optimize.replay``); the first step runs them eager, which loads
    every kernel the capture records.  The graphs die with the object, at
    the end of its pass.  On the CPU every step runs eager."""

    def __init__(self, cp: Compact, settings: RasterSettings,
                 n_tiles_full: int):
        self.cp, self.settings, self.n_tiles_full = cp, settings, n_tiles_full
        dev = cp.rows.device
        Ac, Tc = cp.rows.shape[0], cp.frames["tile_rows"].shape[1]
        self.graphs = None
        self.leaves = {k: torch.empty_like(cp.params[k]).requires_grad_()
                       for k in PARAM_KEYS}
        self.idx = torch.zeros((1,), dtype=torch.int64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        px = (Tc, blend.NPIX)
        self.tiles = blend.TileOutputs(
            color=torch.empty(px + (3,), **f32, requires_grad=True),
            depth=torch.empty(px, **f32, requires_grad=True),
            depth_index=torch.empty(px, dtype=torch.int32, device=dev),
            color_index=torch.empty(px, dtype=torch.int32, device=dev),
            depth_weight=torch.empty(px, **f32),
            color_weight=torch.empty(px, **f32), T_final=torch.empty(px, **f32))
        self.g_feat = torch.empty((Ac + 1, blend.NFEAT), **f32)
        self.one = torch.ones((), **f32)
        self.ident = torch.arange(Ac, dtype=torch.int32, device=dev)

    def _frame(self, keys):
        """The step's frame, gathered by the device index."""
        return {k: self.cp.frames[k].index_select(0, self.idx)[0]
                for k in keys}

    def _stage_a(self):
        with torch.enable_grad():
            cam = self._frame(("w2c", "K", "campos"))
            gauss = compact_gaussians(self.leaves, self.cp.row_valid)
            feat = compact_feature_rows(gauss, cam, self.settings)
            # made last, so its gradient terms are summed first (see above)
            attach = _attach_loss(self.leaves, self.cp.update, self.cp.hyper)
        self.a_out = (feat, gauss["normal"], attach)
        self.feat = feat.detach().requires_grad_()
        self.normal = gauss["normal"].detach().requires_grad_()

    def _stage_c(self):
        with torch.enable_grad():
            frame = self._frame(("color", "depth", "normal", "render_mask",
                                 "tile_rows"))
            out = compact_outputs(self.tiles, self.normal, frame["tile_rows"],
                                  self.n_tiles_full, self.settings)
            total, report = _image_total(out, frame, self.cp.hyper)
            self.cot = torch.autograd.grad(
                total, (self.tiles.color, self.tiles.depth, self.normal))
        self.report = {k: x.detach() for k, x in report.items()}

    def _stage_a_bwd(self):
        leaves = [self.leaves[k] for k in PARAM_KEYS]
        grads = _seeded_grad(self.a_out, leaves,
                             (self.g_feat, self.cot[2], self.one))
        self.grads = {k: torch.zeros_like(x) if g is None else g
                      for k, x, g in zip(PARAM_KEYS, leaves, grads)}

    def _run(self, n: int):
        if self.graphs is None:
            (self._stage_a, self._stage_c, self._stage_a_bwd)[n]()
        else:
            self.graphs[n].replay()

    def _capture(self):
        pool, side = cuda_graphs.thread_pool(self.idx.device)
        self.a_out = self.feat = self.normal = self.cot = self.grads = None
        self.graphs = cuda_graphs.capture(
            (self._stage_a, self._stage_c, self._stage_a_bwd), side, pool=pool)

    def __call__(self, i: int, f: int, params):
        """(gradients, report) of step ``i`` on frame ``f`` at ``params``."""
        fr, s = self.cp.frames, self.settings
        with torch.no_grad():
            for k in PARAM_KEYS:
                self.leaves[k].copy_(params[k])
            self.idx.fill_(f)
        if self.graphs is None and i > 0 and self.idx.device.type == "cuda":
            with perf.span("optimize.capture"):
                self._capture()
        with perf.span("optimize.replay") if self.graphs else nullcontext():
            self._run(0)
            index = (RowIndex(fr["row_ptr_c"][f], fr["pos_c"][f])
                     if "row_ptr_c" in fr else None)
            with torch.enable_grad():
                out = blend.blend_tiles_fused(
                    self.feat, self.ident, fr["tile_lists_c"][f],
                    fr["tile_counts_c"][f], fr["tile_origins"][f],
                    s.opaque_threshold, s.T_threshold, index)
            with torch.no_grad():
                for dst, src in zip(self.tiles, out):
                    dst.copy_(src)
            self._run(1)
            g_feat, = _seeded_grad((out.color, out.depth), (self.feat,),
                                   self.cot[:2])
            with torch.no_grad():
                self.g_feat.copy_(g_feat)
            self._run(2)
            grads = self.grads
            report = dict(self.report, attach=self.a_out[2].detach())
            if self.graphs is not None:   # the next replay rewrites them
                grads = {k: g.clone() for k, g in grads.items()}
                report = {k: x.clone() for k, x in report.items()}
        return grads, report


def optimize_execute(state: MapState, colors, depths, normals, w2cs, Ks,
                     camposes, rmasks, lists_orig, counts,
                     pool_rows: torch.Tensor, n_pool: int,
                     tile_rows: torch.Tensor, frame_seq: Sequence[int],
                     n_iters: int, lrs, weights, settings: RasterSettings,
                     mode: str, max_weight: float, Ktc: int,
                     blend_for=None):
    """Stage 2 of the compact path (``optimize_execute`` :450): the loop
    over the :func:`compact_problem` of the pool rows ``pool_rows`` and the
    live-first tiles ``tile_rows``, then the local history merge.  Updates
    ``state``; returns the last report.  ``blend_for(lists, counts,
    origins, n_rows)``, called once per frame on its compact lists over the
    ``n_rows`` pool rows, returns the blend that frame's renders use in
    place of :func:`blend.blend_tiles_fused` (``parallel/sp_optimize.py``)."""
    hist = map_ops.capture_history(state)
    with perf.span("optimize.prepare"):
        cp = compact_problem(state, colors, depths, normals, w2cs, Ks,
                             camposes, rmasks, lists_orig, counts, pool_rows,
                             n_pool, tile_rows, weights, hist, settings, mode,
                             Ktc)
    aux = {"update_mask": cp.update, "row_valid": cp.row_valid}
    n_tiles_full = counts.shape[1]
    fr = cp.frames
    blends = [None if blend_for is None else
              blend_for(fr["tile_lists_c"][f], fr["tile_counts_c"][f],
                        fr["tile_origins"][f], cp.rows.shape[0])
              for f in range(fr["tile_rows"].shape[0])]

    def frame_of(f):
        return dict({k: x[f] for k, x in fr.items()},
                    n_tiles_full=n_tiles_full, blend_fn=blends[f])

    stages = (CompactStages(cp, settings, n_tiles_full)
              if use_stages(cp.rows.device, n_iters, blend_for) else None)
    params_c, conf_c, report = _iterate(
        cp.params, state.confidence[cp.rows],
        lambda p, frame: _loss_fn_compact(p, aux, frame, settings, cp.hyper),
        frame_of, frame_seq, n_iters, lrs, cp.update, stages)
    del stages   # the pass's graphs and their memory

    # ---- scatter the valid rows back into the map ---------------------------
    with torch.no_grad():
        with perf.span("optimize.rows_fetch"):
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
    with perf.span("render.prepare"):
        bins = [binning.bin_gaussians(
            project_geometry(gauss0["xyz"], gauss0["scales"],
                             gauss0["rotations"], gauss0["alive"], w2cs[f],
                             Ks[f], W, H, settings.scale_modifier),
            H, W, settings.block_capacity, settings.tile_capacity,
            settings.max_visible, tile_mask=tiles[f])
            for f in range(w2cs.shape[0])]
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
    with perf.span("optimize.prepare"):
        rmasks, tiles = _make_masks(state, colors, w2cs, Ks, camposes,
                                    settings, mode, sample_ratio)
        if mask_depth_positive:
            rmasks = rmasks & (depths > 0)
        frames = {"color": colors, "depth": depths, "normal": normals,
                  "w2c": w2cs, "K": Ks, "campos": camposes,
                  "render_mask": rmasks, "tile_mask": tiles}
        if freeze_binning:
            frames.update(zip(("bin_order", "bin_tile_lists",
                               "bin_tile_counts"),
                              _frozen_bins(state, render_alive, w2cs, Ks,
                                           tiles, settings)))
    report = run_optimize(state, frames, frame_seq, n_iters, render_alive,
                          update_mask, lrs, hyper, settings)
    if local:
        map_ops.history_merge(state, hist, max_weight, unstable_mask(state))
    return report
