"""Frame-parallel map optimization over a mesh.

Port of ``rtgslam_tpu/parallel/sharded.py``.  Every shard holds one frame
of an ``[F == mesh size]`` batch; the gaussian parameters are replicated.
Per iteration each shard renders its frame, takes its loss and gradient
(K1 in residual mode forward, K2 and the reduce backward) on its own
device, the gradients are averaged over the mesh (:meth:`Mesh.mean`, the
JAX ``lax.pmean``), and one masked Adam step runs on the state's device;
its result is the next iteration's replicated parameters.  One update
broadcast equals JAX's n replicated updates of the same averaged gradient.

With the same frame on every shard of a power-of-two mesh the averaged
gradient is the one-frame gradient bit for bit, so :func:`dp_local_optimize`
equals ``optimize.optimize_chain(mode="local")`` on that frame exactly.

Entry points update the map state in place and return the loss report's
``total`` averaged over the shards.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..models import map_ops
from ..models import optimize as opt_mod
from ..models.gaussian_map import (STABLE, UNSTABLE, GaussianMapConfig,
                                   MapState, alive_mask, stable_mask,
                                   unstable_mask)
from ..ops.rasterize.api import RasterSettings
from .mesh import Mesh, make_mesh

FRAME_KEYS = ("color", "depth", "normal", "w2c", "K", "campos")


def _state_on(state: MapState, device) -> MapState:
    """``state`` where it already lives on ``device``, else a copy there."""
    if state.xyz.device == torch.device(device):
        return state
    return MapState(**{f.name: getattr(state, f.name).to(device)
                       for f in dataclasses.fields(MapState)})


def _frame_shards(mesh: Mesh, frames: Dict[str, torch.Tensor]) -> List[Dict]:
    """Frame ``s`` of the stacked ``frames`` on shard ``s``'s device."""
    n_frames = frames["color"].shape[0]
    if n_frames != mesh.size:
        raise ValueError(f"{n_frames} frames for a mesh of {mesh.size} shards: "
                         "one frame per shard")
    return [{k: x[s].to(d) for k, x in frames.items()}
            for s, d in enumerate(mesh.devices)]


def _dp_loop(mesh: Mesh, params, confidence, shard_losses: Sequence[Callable],
             n_steps: int, lrs, update_mask):
    """The frame-parallel loop (the ``fori_loop`` bodies of :39-:108,
    :108-:200, :200-:296): per iteration every shard's gradient at the
    replicated parameters, their mesh mean, one masked Adam step and, when
    ``confidence`` is given, the confidence bump from the averaged colour
    gradient.  Returns (params, confidence, the last iteration's total
    averaged over the shards)."""
    home = update_mask.device
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    m, v = zeros, {k: z.clone() for k, z in zeros.items()}
    total = torch.zeros((), device=home)
    for i in range(n_steps):
        grads, totals = [], []
        for loss_fn, replica in zip(shard_losses, mesh.broadcast(params)):
            g, report = opt_mod.loss_grads(loss_fn, replica)
            grads.append(g)
            totals.append(report["total"])
        grads = {k: g.to(home) for k, g in mesh.mean(grads).items()}
        params, m, v = opt_mod._adam_step(params, grads, m, v, i, lrs,
                                          update_mask)
        if confidence is not None:
            confidence = opt_mod.bump_confidence(confidence, grads, update_mask)
        total = mesh.mean(totals).to(home)
    return params, confidence, total


def _write_params(state: MapState, params, confidence=None) -> None:
    with torch.no_grad():
        for k in opt_mod.PARAM_KEYS:
            getattr(state, k).copy_(params[k])
        if confidence is not None:
            state.confidence.copy_(confidence)


def dp_optimize_step(state: MapState, frames: Dict[str, torch.Tensor],
                     render_alive: torch.Tensor, update_mask: torch.Tensor,
                     lrs, hyper, settings: RasterSettings, mesh: Mesh,
                     n_steps: int = 1) -> torch.Tensor:
    """``n_steps`` frame-parallel steps (``dp_optimize_step`` :39):
    ``frames`` holds the stacked color, depth, normal, w2c, K, campos,
    render_mask and tile_mask of one frame per shard; ``hyper`` the loss
    weights and the history rows.  Moves the parameters only; a fresh Adam
    state per call."""
    shards = _frame_shards(mesh, frames)
    aux = mesh.broadcast({"render_alive": render_alive,
                          "update_mask": update_mask})
    hyp = mesh.broadcast(hyper)
    losses = [lambda p, a=a, f=f, h=h: opt_mod._loss_fn(p, a, f, settings, h)
              for a, f, h in zip(aux, shards, hyp)]
    params = {k: getattr(state, k) for k in opt_mod.PARAM_KEYS}
    params, _, total = _dp_loop(mesh, params, None, losses, n_steps, lrs,
                                update_mask)
    _write_params(state, params)
    return total


def _hyper(weights, hist) -> Dict:
    return dict(weights, hist_opacity=hist["opacity"],
                hist_scaling=hist["scaling"], hist_xyz=hist["xyz"],
                hist_rotation_raw=hist["rotation_raw"])


def _masked_shards(state: MapState, mesh: Mesh, frames, settings, mode: str,
                   sample_ratio: float, mask_depth_positive: bool) -> List[Dict]:
    """Every shard's frame with the partial-render masks rendered on its
    own device from the replicated map (:157-169, :248-256): the frame's
    ``optimize._make_masks``, then the valid-depth restriction."""
    out = []
    for f in _frame_shards(mesh, frames):
        st = _state_on(state, f["color"].device)
        rmasks, tiles = opt_mod._make_masks(
            st, f["color"][None], f["w2c"][None], f["K"][None],
            f["campos"][None], settings, mode, sample_ratio)
        rmask = rmasks[0]
        if mask_depth_positive:
            rmask = rmask & (f["depth"] > 0)
        out.append(dict(f, render_mask=rmask, tile_mask=tiles[0]))
    return out


def _windowed(state: MapState, frames, n_steps: int, lrs, weights,
              settings: RasterSettings, mesh: Mesh, mode: str,
              sample_ratio: float, mask_depth_positive: bool, bump: bool):
    """The shared body of :func:`dp_local_optimize` and
    :func:`dp_global_optimize`.  Returns (history snapshot, total)."""
    local = mode == "local"
    pool = stable_mask(state) if not local else unstable_mask(state)
    render_alive = alive_mask(state) if local else pool
    hist = map_ops.capture_history(state)
    shards = _masked_shards(state, mesh, frames, settings, mode, sample_ratio,
                            mask_depth_positive)
    aux = mesh.broadcast({"render_alive": render_alive, "update_mask": pool})
    hyp = mesh.broadcast(_hyper(weights, hist))
    losses = [lambda p, a=a, f=f, h=h: opt_mod._loss_fn(p, a, f, settings, h)
              for a, f, h in zip(aux, shards, hyp)]
    params = {k: getattr(state, k) for k in opt_mod.PARAM_KEYS}
    params, confidence, total = _dp_loop(
        mesh, params, state.confidence if bump else None, losses, n_steps,
        lrs, pool)
    _write_params(state, params, confidence)
    return hist, total


def _stack(colors, depths, normals, w2cs, Ks, camposes):
    return dict(zip(FRAME_KEYS, (colors, depths, normals, w2cs, Ks, camposes)))


def dp_global_optimize(state: MapState, colors, depths, normals, w2cs, Ks,
                       camposes, n_steps: int, lrs, weights,
                       settings: RasterSettings, mesh: Mesh,
                       sample_ratio: float = 0.4,
                       mask_depth_positive: bool = False) -> torch.Tensor:
    """Keyframe-window refinement of the stable pool, one keyframe per
    shard (``dp_global_optimize`` :108).  Each shard renders its keyframe's
    masks from the stable pool: with ``sample_ratio > 0`` the top colour
    error tiles (the error zeroed where the render's colour sums to 0),
    else ``T != 1`` with every tile on.  The stable pool is rendered and
    updated; the confidence and the history stay as they are, as in JAX."""
    _, total = _windowed(state, _stack(colors, depths, normals, w2cs, Ks,
                                       camposes),
                         n_steps, lrs, weights, settings, mesh, "global",
                         sample_ratio, mask_depth_positive, bump=False)
    return total


def dp_local_optimize(state: MapState, colors, depths, normals, w2cs, Ks,
                      camposes, n_steps: int, lrs, weights,
                      settings: RasterSettings, mesh: Mesh,
                      mask_depth_positive: bool = False,
                      max_weight: float = 10.0) -> torch.Tensor:
    """Local optimization of the unstable pool over the memory window, one
    memory frame per shard (``dp_local_optimize`` :200).  Each shard
    renders its frame's unstable-pool transmission: ``T != 1`` is the loss
    mask, its >= 50 % tiles gate the blend.  Every iteration bumps the
    confidence from the averaged colour gradient; the history merge follows
    the loop."""
    hist, total = _windowed(state, _stack(colors, depths, normals, w2cs, Ks,
                                          camposes),
                            n_steps, lrs, weights, settings, mesh, "local",
                            -1.0, mask_depth_positive, bump=True)
    with torch.no_grad():
        map_ops.history_merge(state, hist, max_weight, unstable_mask(state))
    return total


# ---------------------------------------------------------------------------
# the multi-device dry run on a tiny problem
# ---------------------------------------------------------------------------

def _tiny_problem(n_frames: int, H: int = 32, W: int = 32, P_cap: int = 256,
                  device="cpu"):
    """(state, frames, settings) of ``sharded.py::_tiny_problem`` (:300),
    from the same numpy draws: 64 unstable gaussians in front of the
    camera, ``n_frames`` identical frames (grey, depth 2, normal toward the
    camera) at the origin, every pixel and tile on."""
    state = MapState.create(GaussianMapConfig(capacity=P_cap, temp_capacity=32),
                            device)
    rng = np.random.default_rng(0)
    n_alive = 64
    f32 = dict(dtype=torch.float32, device=device)
    with torch.no_grad():
        state.xyz[:n_alive] = torch.as_tensor(
            rng.uniform([-1, -1, 1.5], [1, 1, 3.5], (n_alive, 3)), **f32)
        state.scaling[:n_alive] = float(np.float32(np.log(0.1)))
        state.opacity[:n_alive] = 2.0
        state.status[:n_alive] = UNSTABLE
    K = torch.tensor([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], **f32)
    ty, tx = (H + 15) // 16, (W + 15) // 16
    frames = {
        "color": torch.full((n_frames, H, W, 3), 0.5, **f32),
        "depth": torch.full((n_frames, H, W), 2.0, **f32),
        "normal": torch.tensor([0.0, 0, -1], **f32).expand(
            n_frames, H, W, 3).contiguous(),
        "w2c": torch.eye(4, **f32).expand(n_frames, 4, 4).contiguous(),
        "K": K.expand(n_frames, 3, 3).contiguous(),
        "campos": torch.zeros((n_frames, 3), **f32),
        "render_mask": torch.ones((n_frames, H, W), dtype=torch.bool,
                                  device=device),
        "tile_mask": torch.ones((n_frames, ty, tx), dtype=torch.int32,
                                device=device),
    }
    settings = RasterSettings(height=H, width=W, block_capacity=128,
                              tile_capacity=64)
    return state, frames, settings


def _copy(state: MapState) -> MapState:
    return MapState(**{f.name: getattr(state, f.name).clone()
                       for f in dataclasses.fields(MapState)})


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One frame-parallel step, a local and a global window pass, and the
    tile-sharded compact loop on ``_tiny_problem`` over ``n_devices``
    shards of ``device`` (``dryrun_multichip`` :331), each held to a finite
    loss; the step must move the parameters."""
    from .sp_optimize import sp_optimize_execute

    mesh = make_mesh(devices=[device] * n_devices)
    state, frames, settings = _tiny_problem(n_devices, device=device)
    lrs = {k: 1e-3 for k in opt_mod.PARAM_KEYS}
    weights = {"color_weight": 0.8, "depth_weight": 1.0, "normal_weight": 0.0,
               "add_depth_thres": 0.1}
    hyper = dict(weights, hist_opacity=state.opacity, hist_scaling=state.scaling,
                 hist_xyz=state.xyz, hist_rotation_raw=state.rotation)
    stepped = _copy(state)
    loss = float(dp_optimize_step(stepped, frames, alive_mask(state),
                                  unstable_mask(state), lrs, hyper, settings,
                                  mesh))
    delta = float((stepped.xyz - state.xyz).abs().max())
    if not np.isfinite(loss):
        raise RuntimeError("dp_optimize_step: non-finite loss")
    if not delta > 0:
        raise RuntimeError("dp_optimize_step did not update the parameters")
    window = tuple(frames[k] for k in FRAME_KEYS)

    loc = _copy(state)
    loc_loss = float(dp_local_optimize(loc, *window, 2, lrs, weights, settings,
                                       mesh))
    if not np.isfinite(loc_loss):
        raise RuntimeError("dp_local_optimize: non-finite loss")

    glob = _copy(state)
    glob.status[:32] = STABLE
    glob_loss = float(dp_global_optimize(glob, *window, 2, lrs, weights,
                                         settings, mesh, sample_ratio=0.4))
    if not np.isfinite(glob_loss):
        raise RuntimeError("dp_global_optimize: non-finite loss")

    sp = _copy(state)
    prep = opt_mod.optimize_prepare(sp, *window, settings, "local", -1.0, False)
    report = sp_optimize_execute(
        sp, *window, prep.rmasks, prep.lists_orig, prep.counts,
        prep.pool_order[:max(prep.n_pool, 1)], prep.n_pool,
        prep.tile_order[:, :max(prep.n_live_tiles, 1)], np.zeros(2, np.int64),
        2, lrs, weights, settings, "local", 5.0,
        opt_mod.list_crop(prep.cnt_max, prep.lists_orig.shape[-1]), mesh)
    sp_loss = float(report["total"])
    if not np.isfinite(sp_loss):
        raise RuntimeError("sp_optimize_execute: non-finite loss")
    print(f"[dryrun_multichip] mesh={mesh.size} x {mesh.devices[0]} "
          f"loss={loss:.4f} max|dxyz|={delta:.2e} local_loss={loc_loss:.4f} "
          f"global_loss={glob_loss:.4f} sp_loss={sp_loss:.4f} OK")
