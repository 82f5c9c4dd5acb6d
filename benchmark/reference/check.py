"""The numbers that decide ``correct``, each the program's output measured
against the plain reference (``render.py``) or the generator's ground truth.

Readings (each compared with its limit in ``limits/<workload>.json``):

- ``pose_err_max_cm``: the largest camera-position error of the first
  session's tracked trajectory after Horn alignment to the ground truth.
- ``pose_rot_err_max_deg``: the largest camera-orientation error of the
  same trajectory, both in the first frame's coordinates.
- ``render_p99``: the 99th percentile over pixels of the largest colour
  difference of the port's eval render from the reference's render of the
  same map at the same camera (a percentile, so that the few pixels where
  rounding tips a threshold do not decide it).
- ``k2_grad_rel``: the sampled K2 launch's gradient against the gradient of
  the reference blend of the same rows and lists under the same cotangents
  (autograd): per column the norm of the difference over the larger of the
  column's norm and the median column's norm, the worst column.
- ``adam_rel``, ``adam_m_rel``, ``adam_v_rel``: the sampled Adam step's
  parameter change, first and second moments against the reference's step
  from the same parameters, gradients and moments (betas 0.9 and 0.999,
  eps 1e-15, bias correction at the step's own t, the rows outside the
  update mask neither seeing their gradient nor moving): per parameter
  group the norm of the difference over the larger of the group's norm and
  the median group's, the worst group.
- ``spawn_gap_mm``: the median distance along the ray between each
  Gaussian the first frame spawned and the depth at its pixel that the
  frame was spawned from: the sensor's depth, through the configuration's
  bilateral filter where it has one (recomputed here).

The reference follows the program from its own state (the map, the rows and
lists of one launch, the loss's cotangents, the optimizer's moments):
``PERF.md`` says so.  It runs after the window, on the device, in blocks of
tiles.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

import stats
from reference import render

TILE_BLOCK = 512


def _colour_p99(a: torch.Tensor, b: torch.Tensor) -> float:
    d = torch.abs(a.double() - b.double()).amax(dim=-1).reshape(-1)
    return float(torch.quantile(d, 0.99))


def pose_readings(first: Dict, seq: Dict, control: Optional[str]) -> Dict[str, float]:
    est = first["poses"]
    gt = seq["poses"][:len(est)]
    if control == "tf32":
        est = render.tf32(torch.as_tensor(gt, dtype=torch.float32)).double().numpy()
    return {"pose_err_max_cm": float(stats.position_errors_m(est, gt).max() * 100.0),
            "pose_rot_err_max_deg": float(stats.rotation_errors_deg(est, gt).max())}


def render_settings(cfg: Dict) -> Dict:
    """The render's size and thresholds, from the configuration."""
    a = cfg["args"]
    degree = a["active_sh_degree"] if a["active_sh_degree"] >= 0 else a["max_sh_degree"]
    return dict(height=cfg["frame_size"][0], width=cfg["frame_size"][1],
                sh_degree=int(degree),
                normal_threshold=math.cos(math.radians(a["renderer_normal_threshold"])),
                opaque_threshold=float(a["renderer_opaque_threshold"]))


def render_reading(kept: Dict, seq: Dict, cfg: Dict, device,
                   control: Optional[str]) -> float:
    r = kept["render"]
    state = {k: v.to(device) for k, v in r["state"].items()}
    w2c = r["w2c"]
    cam = {"w2c": torch.as_tensor(w2c, dtype=torch.float32, device=device),
           "K": torch.as_tensor(seq["K"], dtype=torch.float32, device=device),
           "campos": torch.as_tensor(np.linalg.inv(w2c)[:3, 3],
                                     dtype=torch.float32, device=device)}
    kw = render_settings(cfg)
    with torch.no_grad():
        ref = render.render(state, cam, **kw)["colour"]
        got = (render.render(state, cam, low=True, **kw)["colour"]
               if control == "tf32" else r["colour"].to(device))
    return _colour_p99(got, ref)


def reference_blend_grad(args, device, low: bool = False) -> torch.Tensor:
    """d(loss)/d(feat) [V+1, 10] of the reference blend, the loss the
    cotangents the port's backward received define."""
    (feat, _order, lists, counts, origins, _entry, _done, _cc, g_colour,
     g_depth, tfin_gt, _didx, opaque) = args[:13]
    feat = feat.to(device).float()
    if low:
        feat = render.tf32(feat)
    grad = torch.zeros_like(feat)
    T = lists.shape[0]
    for s in range(0, T, TILE_BLOCK):
        sl = slice(s, s + TILE_BLOCK)
        f = feat.detach().requires_grad_(True)
        out = render.blend(f, lists[sl].to(device), counts[sl].to(device),
                           origins[sl].to(device), float(opaque))
        T_fin = out["T"]
        tg = tfin_gt[sl].to(device)
        g_T = torch.where(T_fin.detach() > 0, tg / T_fin.detach().clamp(min=1e-38),
                          torch.zeros_like(tg))
        loss = (torch.sum(out["colour"] * g_colour[sl].to(device))
                + torch.sum(out["depth"] * g_depth[sl].to(device))
                + torch.sum(T_fin * g_T))
        if loss.requires_grad:   # a block of empty tiles reaches no row
            loss.backward()
            grad += f.grad
    grad[-1] = 0.0
    return grad[:, :10]


def k2_reading(kept: Dict, device, control: Optional[str]) -> float:
    k2 = kept["k2"]
    ref = reference_blend_grad(k2["args"], device).double()
    got = (reference_blend_grad(k2["args"], device, low=True)
           if control == "tf32" else k2["grad"].to(device)[:, :10]).double()
    col_ref = torch.linalg.vector_norm(ref, dim=0)
    floor = torch.maximum(col_ref, torch.median(col_ref))
    rel = torch.linalg.vector_norm(got - ref, dim=0) / floor.clamp(min=1e-30)
    return float(rel.max())


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-15


def adam_step(grads, m, v, step: int, lrs, mask, low: bool = False):
    """Adam's parameter change and new moments at 0-based iteration
    ``step`` (bias correction at t = step + 1), in float64 (``low``: from
    TF32-rounded gradients and moments, in float32).  Rows outside ``mask``
    see a zero gradient and do not move."""
    t = step + 1
    c1, c2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
    change, new_m, new_v = {}, {}, {}
    for k, g in grads.items():
        if low:
            g, mk, vk = (render.tf32(x.float()) for x in (g, m[k], v[k]))
        else:
            g, mk, vk = g.double(), m[k].double(), v[k].double()
        keep = mask.reshape((-1,) + (1,) * (g.ndim - 1))
        g = torch.where(keep, g, torch.zeros_like(g))
        new_m[k] = ADAM_B1 * mk + (1 - ADAM_B1) * g
        new_v[k] = ADAM_B2 * vk + (1 - ADAM_B2) * g * g
        step_k = lrs[k] * (new_m[k] / c1) / (torch.sqrt(new_v[k] / c2) + ADAM_EPS)
        change[k] = torch.where(keep, -step_k, torch.zeros_like(step_k))
    return change, new_m, new_v


def _worst_group(got: Dict, ref: Dict) -> float:
    """Per group the norm of the difference over the larger of the group's
    reference norm and the median group's; the worst group."""
    norms = {k: float(torch.linalg.vector_norm(ref[k])) for k in ref}
    floor = float(np.median(list(norms.values())))
    return max(float(torch.linalg.vector_norm(got[k].double() - ref[k]))
               / max(norms[k], floor, 1e-30) for k in ref)


def adam_readings(kept: Dict, device, control: Optional[str]) -> Dict[str, float]:
    a = kept["adam"]
    dev = lambda d: {k: x.to(device) for k, x in d.items()}
    params, grads, m, v = dev(a["params"]), dev(a["grads"]), dev(a["m"]), dev(a["v"])
    mask = a["mask"].to(device)
    ref = adam_step(grads, m, v, a["step"], a["lrs"], mask)
    if control == "tf32":
        got = adam_step(grads, m, v, a["step"], a["lrs"], mask, low=True)
    else:
        got = ({k: a["new"][k].to(device).double() - params[k].double()
                for k in grads}, dev(a["new_m"]), dev(a["new_v"]))
    return {name: _worst_group(g, r) for name, g, r in
            zip(("adam_rel", "adam_m_rel", "adam_v_rel"), got, ref)}


def bilateral(depth: torch.Tensor, radius: int = 5, sigma_color: float = 2.0,
              sigma_space: float = 2.0) -> torch.Tensor:
    """RTG-SLAM's bilateral depth filter in float64: over the disc of
    ``radius`` pixels, weights exp(-r^2 / 2 sigma_space^2 - dz^2 / 2
    sigma_color^2) on the neighbours with a depth, the weighted mean of
    their depths; 0 where no neighbour has one."""
    d = depth.double()
    H, W = d.shape
    pad = torch.nn.functional.pad(d, (radius,) * 4)
    wsum = torch.zeros_like(d)
    psum = torch.zeros_like(d)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            r2 = dy * dy + dx * dx
            if r2 > radius * radius:
                continue
            nb = pad[radius + dy:radius + dy + H, radius + dx:radius + dx + W]
            w = torch.exp(-r2 / (2 * sigma_space ** 2)
                          - (d - nb) ** 2 / (2 * sigma_color ** 2)) * (nb != 0)
            wsum += w
            psum += w * nb
    return torch.where(wsum > 0, psum / wsum.clamp(min=1e-300), torch.zeros_like(d))


def spawn_reading(kept: Dict, seq: Dict, cfg: Dict, device,
                  control: Optional[str]) -> float:
    sp = kept["spawn"]
    xyz = sp["xyz"].double().cpu().numpy()
    c2w = seq["poses"][sp["uid"]]
    w2c = np.linalg.inv(c2w)
    if control == "tf32":
        xyz = render.tf32(torch.as_tensor(xyz, dtype=torch.float32)).double().numpy()
    p = xyz @ w2c[:3, :3].T + w2c[:3, 3]
    K = seq["K"]
    depth = torch.as_tensor(seq["depth"][sp["uid"]][..., 0], device=device)
    if cfg["args"].get("depth_filter"):
        depth = bilateral(depth)
    depth = depth.double().cpu().numpy()
    H, W = depth.shape
    u = np.rint(K[0, 0] * p[:, 0] / p[:, 2] + K[0, 2]).astype(np.int64)
    v = np.rint(K[1, 1] * p[:, 1] / p[:, 2] + K[1, 2]).astype(np.int64)
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (p[:, 2] > 0)
    if not inside.any():
        return float("inf")
    gap = np.abs(p[inside, 2] - depth[v[inside], u[inside]])
    # off-image centres count as misplaced
    gap = np.concatenate([gap, np.full(int((~inside).sum()), np.inf)])
    return float(np.median(gap) * 1e3)


def readings(kept: Dict, first: Dict, seq: Dict, cfg: Dict, device,
             control: Optional[str] = None) -> Dict[str, float]:
    out = pose_readings(first, seq, control)
    if "render" in kept:
        out["render_p99"] = render_reading(kept, seq, cfg, device, control)
    if "adam" in kept:
        out.update(adam_readings(kept, device, control))
    if "k2" in kept:
        out["k2_grad_rel"] = k2_reading(kept, device, control)
    if "spawn" in kept:
        out["spawn_gap_mm"] = spawn_reading(kept, seq, cfg, device, control)
    return out
