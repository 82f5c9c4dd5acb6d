"""Gaussian-map lifecycle operations over the fixed-capacity ``MapState``.

Port of ``rtgslam_tpu/models/map_ops.py``.  Spawning samples a fixed-size
candidate set with a validity mask, deletion clears status flags, and the
functions that change the map update ``state`` IN PLACE (the JAX versions
return a new pytree; the map is one SoA either way, so no donated twins are
needed here).

Randomness is an input: :func:`spawn_step` takes the two [H*W] pixel
priority vectors that JAX draws with ``jax.random.uniform`` (:65).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..ops import knn as knn_ops
from ..ops import segment as segment_ops
from ..ops.rasterize.api import (render, render_model_and_stable,
                                 render_with_inserted)
from ..utils import perf
from ..utils import sh as sh_utils
from ..utils.geometry import normalize, quat_align_z_to
from .gaussian_map import (FREE, STABLE, UNSTABLE, GaussianMapConfig, MapState,
                           alive_mask, derived_normal, gaussian_radius,
                           render_inputs, stable_mask)


class TempPoints(NamedTuple):
    """Fixed-capacity spawn staging buffer (``TempPoints`` :28)."""

    xyz: torch.Tensor      # [Kt, 3] world
    normal: torch.Tensor   # [Kt, 3] world
    color: torch.Tensor    # [Kt, 3]
    opacity: torch.Tensor  # [Kt, 1] raw logit
    valid: torch.Tensor    # [Kt] bool


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def high_water_mark(state: MapState) -> torch.Tensor:
    """1 + the highest occupied slot index, 0 when the map is empty, as a
    device scalar (``high_water_mark`` :44).  Inserts fill the lowest free
    slots, so every alive row lies below it."""
    idx = torch.arange(1, state.status.shape[0] + 1, dtype=torch.int32,
                       device=state.status.device)
    return torch.max(torch.where(state.status != FREE, idx, 0))


def map_counters(state: MapState):
    """(high-water mark, stable count) as device scalars (``map_counters``
    :503)."""
    return high_water_mark(state), torch.sum(state.status == STABLE)


# ---------------------------------------------------------------------------
# pixel sampling
# ---------------------------------------------------------------------------

def sample_masked_pixels(priority: torch.Tensor, mask: torch.Tensor,
                         n_target, max_n: int):
    """Sample up to ``n_target`` pixels where ``mask`` is set (``:57``).

    ``priority`` [H*W] holds uniform [0, 1) draws.  Picks the ``max_n``
    largest masked priorities as ``lax.top_k`` does (ties to the lowest
    index).  Returns ([max_n] int32 flat indices, [max_n] valid)."""
    pr = torch.where(mask.reshape(-1), priority, -1.0)
    vals, idx = torch.sort(pr, descending=True, stable=True)
    vals, idx = vals[:max_n], idx[:max_n]
    rank = torch.arange(max_n, device=pr.device)
    valid = (vals >= 0.0) & (rank < n_target)
    return idx.to(torch.int32), valid


def gather_temp_points(vertex_w, normal_w, color, idx_a, valid_a, idx_b,
                       valid_b, init_opacity: float) -> TempPoints:
    """Gather the two sampled pixel groups into one temp buffer, dropping
    zero normals (``:74``)."""
    idx = torch.cat([idx_a, idx_b]).long()
    valid = torch.cat([valid_a, valid_b])
    xyz = vertex_w.reshape(-1, 3)[idx]
    nrm = normal_w.reshape(-1, 3)[idx]
    col = color.reshape(-1, 3)[idx]
    valid = valid & (torch.sum(torch.abs(nrm), dim=-1) > 0)
    # the logit is taken of the float64 ratio, as jnp.log of a Python float
    with perf.span("map.constant_upload"):
        ratio = torch.tensor(init_opacity / (1.0 - init_opacity),
                             dtype=torch.float32, device=xyz.device)
    opa = torch.log(ratio)
    return TempPoints(xyz=xyz, normal=normalize(nrm), color=col,
                      opacity=opa.expand(idx.shape[0], 1).clone(), valid=valid)


# ---------------------------------------------------------------------------
# spawn pipeline
# ---------------------------------------------------------------------------

def temp_filter_dedup(temp: TempPoints, state: MapState) -> TempPoints:
    """Drop temp points inside an existing unstable gaussian's 0.6-radius
    3-NN neighbourhood (``:99``, reference mapper.py:797-826).  The KNN
    runs over the unstable rows in slot order, which is the order the JAX
    version's stable partition gives, so ties break alike."""
    with perf.span("map.rows_fetch"):
        ref_rows = torch.nonzero(state.status == UNSTABLE).squeeze(1)
    if ref_rows.numel() == 0:
        return temp
    radius = gaussian_radius(state.scaling[ref_rows])
    with perf.span("map.rows_fetch"):
        q_rows = torch.nonzero(temp.valid).squeeze(1)
    d2, idx = knn_ops.knn(temp.xyz[q_rows], state.xyz[ref_rows],
                          torch.ones_like(ref_rows, dtype=torch.bool), k=3)
    corr = torch.where(idx >= 0, radius[idx.clamp(min=0).long()] * 0.6, 0.0)
    inside = torch.any(torch.sqrt(d2) < corr, dim=-1)
    valid = temp.valid.clone()
    valid[q_rows] = ~inside
    return temp._replace(valid=valid)


def temp_attach_to_stable(temp: TempPoints, state: MapState,
                          stable_color_index: torch.Tensor, w2c, K,
                          height: int, width: int, add_depth_thres: float,
                          low_opacity: float = 0.1) -> TempPoints:
    """Temp points landing on a rendered stable gaussian within half the
    depth-spawn threshold of its plane get low opacity (``:132``,
    reference mapper.py:829-881)."""
    p_c = temp.xyz @ w2c[:3, :3].T + w2c[:3, 3]
    z = torch.clamp(p_c[:, 2], min=1e-6)
    u = torch.floor(K[0, 0] * p_c[:, 0] / z + K[0, 2]).to(torch.int32)
    v = torch.floor(K[1, 1] * p_c[:, 1] / z + K[1, 2]).to(torch.int32)
    inview = (u >= 0) & (u < width) & (v >= 0) & (v < height) & (p_c[:, 2] > 0)
    uc = u.clamp(0, width - 1).long()
    vc = v.clamp(0, height - 1).long()
    sidx = stable_color_index[vc, uc]
    hit = inview & (sidx >= 0)
    gi = sidx.clamp(min=0).long()
    s_normal = derived_normal(state.scaling[gi], state.rotation[gi])
    plane_d = torch.abs(torch.sum((state.xyz[gi] - temp.xyz) * s_normal, dim=-1))
    attach = hit & (plane_d < 0.5 * add_depth_thres) & temp.valid
    low = inverse_sigmoid(torch.full_like(temp.opacity, low_opacity))
    return temp._replace(opacity=torch.where(attach[:, None], low, temp.opacity))


def temp_scale_init(temp: TempPoints, state: MapState,
                    config: GaussianMapConfig):
    """3-NN scale initialization + crowding rejection (``:164``, reference
    ``update_geometry``).  References are the valid temp rows, then the
    alive map rows in slot order (the JAX stable partition's order).
    Returns (filtered temp, log-scales [Kt, 3])."""
    alive = state.status != FREE
    with perf.span("map.rows_fetch"):
        ref_xyz = torch.cat([temp.xyz[temp.valid], state.xyz[alive]])
        ref_radius = torch.cat([
            torch.zeros(int(temp.valid.sum()), device=ref_xyz.device),
            gaussian_radius(state.scaling[alive])])
        q_rows = torch.nonzero(temp.valid).squeeze(1)
    d2, idx = knn_ops.knn(temp.xyz[q_rows], ref_xyz,
                          torch.ones(ref_xyz.shape[0], dtype=torch.bool,
                                     device=ref_xyz.device), k=4)
    d2, idx = d2[:, 1:], idx[:, 1:]   # drop the self match
    dist = (torch.sqrt(torch.where(torch.isinf(d2), 1e12, d2))
            - 3.0 * ref_radius[idx.clamp(min=0).long()])
    dist = torch.where(idx >= 0, dist, 1e6)
    valid = temp.valid.clone()
    valid[q_rows] = ~torch.any(dist < 0, dim=-1)         # crowding rejection
    mean_sq = torch.mean(torch.clamp(dist, max=1e3) ** 2, dim=-1)
    scales = torch.clamp(torch.sqrt(mean_sq), config.min_radius, config.max_radius)
    with perf.span("map.constant_upload"):
        factor = torch.tensor(config.xyz_factor, dtype=torch.float32,
                              device=scales.device)
    log_scales = torch.zeros_like(temp.xyz)              # rows never inserted
    log_scales[q_rows] = torch.log(
        config.scale_factor * scales[:, None] * factor[None, :] + 1e-12)
    return temp._replace(valid=valid), log_scales


def insert_temp(state: MapState, temp: TempPoints, log_scales: torch.Tensor,
                time: int, config: GaussianMapConfig) -> int:
    """Write the valid temp points into the lowest FREE slots as UNSTABLE
    gaussians, in temp order (``:210``: ``jnp.nonzero(size=Kt,
    fill_value=P)`` pairs the k-th valid row with the k-th free slot).
    Capacity overflow drops the tail.  Returns the inserted count."""
    with perf.span("map.rows_fetch"):
        rows = torch.nonzero(temp.valid).squeeze(1)
        free = torch.nonzero(state.status == FREE).squeeze(1)
    n = min(rows.numel(), free.numel())
    rows, slots = rows[:n], free[:n]
    normal = temp.normal[rows]
    if all(f == 1.0 for f in config.xyz_factor):
        rots = torch.zeros((n, 4), device=normal.device)
        rots[:, 0] = 1.0
    else:
        rots = quat_align_z_to(normal)
    state.xyz[slots] = temp.xyz[rows]
    state.features_dc[slots] = sh_utils.rgb_to_sh(temp.color[rows])
    state.scaling[slots] = log_scales[rows]
    state.rotation[slots] = rots
    state.opacity[slots] = temp.opacity[rows]
    # each host scalar goes to the device before its scatter
    with perf.span("map.constant_upload"):
        state.features_rest[slots] = 0.0
        state.confidence[slots] = 0.0
        state.add_tick[slots] = time
        state.depth_error_counter[slots] = 0
        state.color_error_counter[slots] = 0
        state.status[slots] = UNSTABLE
    return n


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def fix_confident(state: MapState, stable_confidence_thres: float) -> None:
    """UNSTABLE -> STABLE where confidence exceeds the threshold, confidence
    clipped at it (``:272``, reference ``gaussians_fix``)."""
    promote = (state.status == UNSTABLE) & (
        state.confidence[:, 0] > stable_confidence_thres)
    state.status[promote] = STABLE
    with perf.span("map.rows_fetch"):
        state.confidence[promote] = torch.clamp(state.confidence[promote],
                                                max=stable_confidence_thres)


def fix_all(state: MapState) -> None:
    """Promote every unstable gaussian (``:286``, final global pass)."""
    state.status[state.status == UNSTABLE] = STABLE


def delete_gaussians(state: MapState, time: int, unstable_time_window: float,
                     unstable: bool = True) -> None:
    """Free oversized gaussians (radius > 10x pool mean) and, for the
    unstable pool, those older than the time window (``:292``)."""
    pool = state.status == (UNSTABLE if unstable else STABLE)
    radius = gaussian_radius(state.scaling)
    pool_n = torch.clamp(pool.sum(), min=1)
    mean_radius = torch.sum(torch.where(pool, radius, 0.0)) / pool_n
    kill = pool & (radius > mean_radius * 10.0)
    if unstable:
        kill |= pool & ((time - state.add_tick[:, 0]) > unstable_time_window)
    state.status[kill] = FREE


def error_update(state: MapState, render_color, render_depth, depth_index,
                 color_index, gt_color, gt_depth, add_color_thres: float,
                 add_depth_thres: float, time: int) -> None:
    """Per-gaussian error strikes + self-healing (``:311``, reference
    mapper.py:510-591): stable gaussians whose mean depth (color) error
    exceeds 2x the spawn threshold get a strike; >= 10 depth strikes
    delete, >= 10 color strikes reset confidence and re-age."""
    gt_d = gt_depth[..., 0] if gt_depth.ndim == 3 else gt_depth
    r_d = render_depth[..., 0] if render_depth.ndim == 3 else render_depth
    depth_err = torch.clamp(gt_d - r_d, min=0.0)   # under-estimation only
    # channel SUM here vs MEAN in spawn_step, as in the reference
    color_err = torch.sum(torch.abs(gt_color - render_color), dim=-1)
    invalid = (gt_d == 0) | (depth_index < 0)
    depth_err = torch.where(invalid, 0.0, depth_err)
    color_err = torch.where(gt_d == 0, 0.0, color_err)
    g_color, g_depth, _ = segment_ops.accumulate_gaussian_error(
        color_err, depth_err, torch.zeros_like(depth_err), color_index,
        depth_index, state.capacity)

    stable = state.status == STABLE
    state.depth_error_counter += (stable & (g_depth > 2.0 * add_depth_thres)
                                  )[:, None].to(torch.int32)
    state.color_error_counter += (stable & (g_color > 2.0 * add_color_thres)
                                  )[:, None].to(torch.int32)
    delete = stable & (state.depth_error_counter[:, 0] >= 10)
    release = stable & (state.color_error_counter[:, 0] >= 10) & ~delete
    state.status[delete] = FREE
    state.confidence[release] = 0.0
    state.add_tick[release] = time


# ---------------------------------------------------------------------------
# history merge
# ---------------------------------------------------------------------------

def _slerp(q0: torch.Tensor, q1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Batched slerp with lerp fallback for near-colinear quaternions and
    q1 flipped into q0's hemisphere (``_slerp`` :367, a documented
    divergence from the reference)."""
    q0n, q1n = normalize(q0), normalize(q1)
    dot = torch.sum(q0n * q1n, dim=-1, keepdim=True)
    flip = torch.where(dot < 0.0, -1.0, 1.0)
    q1, dot = q1 * flip, dot * flip
    colinear = torch.abs(dot) > 0.9995
    theta0 = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin0 = torch.sin(theta0)
    safe_sin0 = torch.where(torch.abs(sin0) < 1e-6, 1.0, sin0)
    s0 = torch.sin((1 - t) * theta0) / safe_sin0
    s1 = torch.sin(t * theta0) / safe_sin0
    slerped = s0 * q0 + s1 * q1
    lerped = q0 + t * (q1 - q0)
    return torch.where(colinear, lerped, slerped)


def capture_history(state: MapState) -> Dict[str, torch.Tensor]:
    """Snapshot of the merge-relevant parameters (``:716``)."""
    return {
        "xyz": state.xyz.clone(),
        "features_dc": state.features_dc.clone(),
        "features_rest": state.features_rest.clone(),
        "scaling": state.scaling.clone(),
        "rotation_act": normalize(state.rotation),
        "rotation_raw": state.rotation.clone(),
        "opacity": state.opacity.clone(),
        "confidence": state.confidence.clone(),
    }


def history_merge(state: MapState, hist: Dict[str, torch.Tensor],
                  max_weight: float, update_mask: torch.Tensor) -> None:
    """EMA the parameters toward their snapshot, weighted by how confident
    each gaussian already was (``:394``, reference mapper.py:212-250);
    rotation slerped in activated space."""
    w = max_weight * hist["confidence"] / (state.confidence + 1e-6)   # [P, 1]
    w = torch.where(update_mask[:, None], w, 0.0)
    rot = _slerp(hist["rotation_act"], normalize(state.rotation), 1.0 - w)
    state.xyz.copy_(hist["xyz"] * w + (1 - w) * state.xyz)
    state.features_dc.copy_(hist["features_dc"] * w + (1 - w) * state.features_dc)
    state.features_rest.copy_(hist["features_rest"] * w[..., None]
                              + (1 - w[..., None]) * state.features_rest)
    state.scaling.copy_(hist["scaling"] * w + (1 - w) * state.scaling)
    state.rotation.copy_(rot)


# ---------------------------------------------------------------------------
# per-frame composites
# ---------------------------------------------------------------------------

def spawn_step(priorities, state: MapState, vertex_w, normal_w, color, depth,
               model_T, model_depth, model_color, model_depth_index,
               stable_color_index, w2c, K, time: int,
               uniform_sample_num: int, transmission_sample_ratio: float,
               error_sample_ratio: float, add_transmission_thres: float,
               add_depth_thres: float, add_color_thres: float,
               config: GaussianMapConfig, max_each: int, height: int,
               width: int, first_frame: bool, has_stable: bool) -> int:
    """The whole ``gaussians_add`` chain: sample -> gather -> dedup ->
    attach -> scale-init -> insert (``spawn_step`` :424, reference
    mapper.py:128-132,715-896).  ``priorities`` = (pa, pb), two [H*W]
    uniform vectors.  Returns the inserted count."""
    pa, pb = priorities
    d = depth[..., 0] if depth.ndim == 3 else depth
    if first_frame:
        idx_a, val_a = sample_masked_pixels(pa, d > 0, uniform_sample_num,
                                            max_each)
        idx_b = torch.zeros((max_each,), dtype=torch.int32, device=d.device)
        val_b = torch.zeros((max_each,), dtype=torch.bool, device=d.device)
    else:
        T = model_T[..., 0]
        trans_mask = (T > add_transmission_thres) & (d > 0)
        trans_num = (transmission_sample_ratio
                     * (trans_mask.sum(dtype=torch.int32) / d.numel())
                     * uniform_sample_num).to(torch.int32)
        idx_a, val_a = sample_masked_pixels(pa, trans_mask, trans_num, max_each)

        depth_err = torch.abs(d - model_depth[..., 0])
        color_err = torch.mean(torch.abs(color - model_color), dim=-1)
        depth_mask = ((depth_err > add_depth_thres) & (d > 0)
                      & (model_depth_index > -1))
        color_mask = ((color_err > add_color_thres) & (d > 0)
                      & (T < add_transmission_thres))
        err_mask = (depth_mask | color_mask) & ~trans_mask
        err_num = (err_mask.sum(dtype=torch.int32).to(torch.float32)
                   * error_sample_ratio).to(torch.int32)
        idx_b, val_b = sample_masked_pixels(pb, err_mask, err_num, max_each)

    temp = gather_temp_points(vertex_w, normal_w, color, idx_a, val_a,
                              idx_b, val_b, config.init_opacity)
    # live rows first, order kept (the insert order the JAX code produces)
    order_t = segment_ops.stable_partition_order(temp.valid).long()
    temp = TempPoints(*(x[order_t] for x in temp))
    temp = temp_filter_dedup(temp, state)
    if has_stable:
        temp = temp_attach_to_stable(temp, state, stable_color_index,
                                     w2c, K, height, width, add_depth_thres)
    temp, log_scales = temp_scale_init(temp, state, config)
    return insert_temp(state, temp, log_scales, time, config)


def lifecycle_step(state: MapState, render_color, render_depth, depth_index,
                   color_index, gt_color, gt_depth,
                   stable_confidence_thres: float, add_color_thres: float,
                   add_depth_thres: float, time: int,
                   unstable_time_window: float) -> None:
    """fix -> error strikes -> unstable delete (``lifecycle_step`` :483,
    reference mapper.py:123-126)."""
    fix_confident(state, stable_confidence_thres)
    error_update(state, render_color, render_depth, depth_index, color_index,
                 gt_color, gt_depth, add_color_thres, add_depth_thres, time)
    delete_gaussians(state, time, unstable_time_window, unstable=True)


def _lifecycle_post_render(state: MapState, out, gt_color, gt_depth, args):
    lifecycle_step(state, out["render"], out["depth"], out["depth_index_map"],
                   out["color_index_map"], gt_color, gt_depth, *args)


def spawn_chain(priorities, state: MapState, frame_map, camera, time: int,
                spawn_args: dict, config: GaussianMapConfig, max_each: int,
                settings, first_frame: bool, has_stable: bool):
    """``spawn_step`` plus the model/stable renders it consumes
    (``spawn_chain`` :512).  Returns (n_inserted, model_out or None on the
    first frame)."""
    H, W = settings.height, settings.width
    dev = state.xyz.device
    if first_frame:
        model_out = None
        zero_hw1 = torch.zeros((H, W, 1), device=dev)
        model_T, model_depth = zero_hw1, zero_hw1
        model_color = torch.zeros((H, W, 3), device=dev)
        model_didx = torch.full((H, W), -1, dtype=torch.int32, device=dev)
        stable_cidx = model_didx
    else:
        model_out, stable_cidx = render_model_and_stable(
            render_inputs(state, alive_mask(state)), stable_mask(state),
            camera, settings)
        model_T, model_depth = model_out["T_map"], model_out["depth"]
        model_color = model_out["render"]
        model_didx = model_out["depth_index_map"]
    n = spawn_step(
        priorities, state, frame_map["vertex_map_w"], frame_map["normal_map_w"],
        frame_map["color_map"], frame_map["depth_map"],
        model_T, model_depth, model_color, model_didx, stable_cidx,
        camera["w2c"], camera["K"], time, config=config, max_each=max_each,
        height=H, width=W, first_frame=first_frame, has_stable=has_stable,
        **spawn_args)
    return n, model_out


def lifecycle_chain(state: MapState, camera, gt_color, gt_depth,
                    lifecycle_args: tuple, settings):
    """``lifecycle_step`` plus the global render it scores against
    (``lifecycle_chain`` :564).  Returns the render."""
    out = render(render_inputs(state, alive_mask(state)), camera, settings)
    _lifecycle_post_render(state, out, gt_color, gt_depth, lifecycle_args)
    return out


def frame_chain(priorities, state: MapState, frame_map, camera, time: int,
                spawn_args: dict, lifecycle_args: tuple,
                config: GaussianMapConfig, max_each: int, settings,
                has_stable: bool):
    """spawn_chain + lifecycle for frames with no optimization pass
    (``frame_chain`` :616).  The lifecycle render is
    :func:`render_with_inserted` of the post-insert state.  Returns
    (n_inserted, model_out, lifecycle render)."""
    n, model_out = spawn_chain(priorities, state, frame_map, camera, time,
                               spawn_args, config, max_each, settings,
                               False, has_stable)
    out = render_with_inserted(render_inputs(state, alive_mask(state)),
                               camera, settings)
    _lifecycle_post_render(state, out, frame_map["color_map"],
                           frame_map["depth_map"], lifecycle_args)
    return n, model_out, out
