"""Projective point-to-plane ICP.

Port of ``rtgslam_tpu/ops/icp.py`` (reference ``SLAM/icp.py``): per pyramid
level, damped Gauss-Newton steps on flat [N] planes, with bilinear
association against the warped target and Huber-weighted residuals.  Twist
order [rot, trans] and the left-Jacobian exponential match ``exp_se3``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import cuda_graphs, perf
from ..utils.geometry import exp_se3
from . import preprocess


def pack_target(vertex: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """[H,W,3] vertex + normal -> [H*W, 6] rows for one-gather warps."""
    N = vertex.shape[0] * vertex.shape[1]
    return torch.cat([vertex.reshape(N, 3), normal.reshape(N, 3)], dim=1)


def _warp_packed(packed: torch.Tensor, H: int, W: int, u: torch.Tensor,
                 v: torch.Tensor, association: str):
    """Sample the packed target at real-valued pixel coords (``:55``).

    Bilinear with border clamp; a sample whose vertex (normal) touches an
    invalid corner falls back to nearest for that part.  Returns six [N]
    planes (rx, ry, rz, rnx, rny, rnz)."""
    ui = torch.round(u).to(torch.int32).clamp(0, W - 1)
    vi = torch.round(v).to(torch.int32).clamp(0, H - 1)
    near = packed[(vi * W + ui).long()]
    if association != "bilinear":
        return tuple(near[:, c] for c in range(6))

    u = u.clamp(0.0, W - 1.0)
    v = v.clamp(0.0, H - 1.0)
    u0 = torch.floor(u).to(torch.int32).clamp(0, W - 2)
    v0 = torch.floor(v).to(torch.int32).clamp(0, H - 2)
    du = u - u0
    dv = v - v0
    lin = (v0 * W + u0).long()
    f00, f01 = packed[lin], packed[lin + 1]
    f10, f11 = packed[lin + W], packed[lin + W + 1]
    w00 = (1 - dv) * (1 - du)
    w01 = (1 - dv) * du
    w10 = dv * (1 - du)
    w11 = dv * du

    def lerp(c):
        return (w00 * f00[:, c] + w01 * f01[:, c]
                + w10 * f10[:, c] + w11 * f11[:, c])

    vert_ok = ((f00[:, 2] != 0) & (f01[:, 2] != 0)
               & (f10[:, 2] != 0) & (f11[:, 2] != 0))
    norm_ok = ((f00[:, 5] != 0) & (f01[:, 5] != 0)
               & (f10[:, 5] != 0) & (f11[:, 5] != 0))
    rx, ry, rz = (torch.where(vert_ok, lerp(c), near[:, c]) for c in (0, 1, 2))
    nx, ny, nz = (torch.where(norm_ok, lerp(c), near[:, c]) for c in (3, 4, 5))
    inv = 1.0 / (torch.sqrt(nx * nx + ny * ny + nz * nz) + 1e-8)
    return rx, ry, rz, nx * inv, ny * inv, nz * inv


def gn_iteration(pose10, src_planes, tgt_packed, H: int, W: int, K,
                 damping: float, distance_threshold: float,
                 normal_threshold: float, association: str,
                 huber_delta: float = 0.02) -> torch.Tensor:
    """One damped Gauss-Newton step of projective point-to-plane ICP with
    Huber weights (``gn_iteration`` :103)."""
    x0, y0, z0, nx0, ny0, nz0 = src_planes
    R, t = pose10[:3, :3], pose10[:3, 3]
    mask0 = z0 > 0.0

    x = R[0, 0] * x0 + R[0, 1] * y0 + R[0, 2] * z0 + t[0]
    y = R[1, 0] * x0 + R[1, 1] * y0 + R[1, 2] * z0 + t[1]
    z = R[2, 0] * x0 + R[2, 1] * y0 + R[2, 2] * z0 + t[2]
    nx = R[0, 0] * nx0 + R[0, 1] * ny0 + R[0, 2] * nz0
    ny = R[1, 0] * nx0 + R[1, 1] * ny0 + R[1, 2] * nz0
    nz = R[2, 0] * nx0 + R[2, 1] * ny0 + R[2, 2] * nz0

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = (x / z_safe) * fx + cx
    v = (y / z_safe) * fy + cy
    inview = (u > 0) & (u < W - 1) & (v > 0) & (v < H - 1) & (z > 0)

    rx, ry, rz, rnx, rny, rnz = _warp_packed(tgt_packed, H, W, u, v, association)
    mask1 = rz > 0.0
    dx, dy, dz = x - rx, y - ry, z - rz
    normal_agree = (nx * rnx + ny * rny + nz * rnz) > normal_threshold
    res = rnx * dx + rny * dy + rnz * dz
    far = (dx * dx + dy * dy + dz * dz) > distance_threshold ** 2
    valid = (inview & ~far & mask0 & mask1 & normal_agree).to(res.dtype)

    # J = [cross(p', n'), n'] (order [rot, trans]); the normal equations come
    # out of one [7, N] x [N, 7] product over the J planes + residual row
    res = res * valid
    A = torch.stack([
        (y * rnz - z * rny) * valid,
        (z * rnx - x * rnz) * valid,
        (x * rny - y * rnx) * valid,
        rnx * valid, rny * valid, rnz * valid,
        res,
    ])
    w = torch.clamp(huber_delta / torch.clamp(torch.abs(res), min=1e-12), max=1.0)
    M = (A * w[None, :]) @ A.T
    JtJ, JtR = M[:6, :6], M[:6, 6]
    Hm = JtJ + (torch.trace(JtJ) * damping) * torch.eye(6, device=JtJ.device)
    xi = -torch.linalg.solve_ex(Hm, JtR)[0]
    return exp_se3(xi) @ pose10


def point2plane_loss(p_t0, p_t1, n_t0) -> torch.Tensor:
    """Mean squared point-to-plane distance (reference icp.py:7-13)."""
    d = torch.sum((p_t1 - p_t0) * n_t0, dim=-1)
    return torch.mean(d * d)


def level_intrinsics(K: torch.Tensor, s: float) -> torch.Tensor:
    """K scaled by ``s`` with ``[2, 2] = 1``: device ops only (the entry is
    filled from a Python scalar, no host tensor is copied), so the host
    does not wait and a graph capture may hold it."""
    Ks = K * s
    Ks[2, 2].fill_(1.0)
    return Ks


def _solve(pose10, vertex1_pyr, vertex0_pyr, normal1_pyr, normal0_pyr, K,
           downscales, iters, damping, distance_threshold, normal_threshold,
           association):
    """The solve itself, eager: what a graph captures and replays."""
    for level, n_iter in enumerate(iters):
        Ks = level_intrinsics(K, downscales[level])
        v1, v0 = vertex1_pyr[level], vertex0_pyr[level]
        n1, n0 = normal1_pyr[level], normal0_pyr[level]
        H, W = v1.shape[:2]
        fv, fn = v1.reshape(-1, 3), n1.reshape(-1, 3)
        src = (fv[:, 0], fv[:, 1], fv[:, 2], fn[:, 0], fn[:, 1], fn[:, 2])
        tgt = pack_target(v0, n0)
        for _ in range(n_iter):
            pose10 = gn_iteration(pose10, src, tgt, H, W, Ks, damping,
                                  distance_threshold, normal_threshold,
                                  association)
    p2p = point2plane_loss(vertex0_pyr[-1],
                           vertex1_pyr[-1] @ pose10[:3, :3].T + pose10[:3, 3],
                           normal0_pyr[-1])
    return pose10, p2p


# A captured solve per key (``cuda_graphs.replay_key``).  A process keeps
# every graph it captures, so later sessions and the loop closer's verifying
# solves replay the first one's; a key past the bound runs eager.
MAX_GRAPHS = 8
_graphs = cuda_graphs.GraphCache(MAX_GRAPHS)


class _SolveGraph:
    """:func:`_solve` captured once as a CUDA graph: static inputs that
    each call copies its tensors into, and static outputs it clones."""

    def __init__(self, inputs, settings):
        t = self.static = [x.clone(memory_format=torch.contiguous_format)
                           for x in inputs]
        n = (len(t) - 2) // 4   # pose, four pyramids of n levels, K
        args = (t[0], *(t[1 + i * n:1 + (i + 1) * n] for i in range(4)), t[-1])

        def solve():
            self.pose10, self.p2p = _solve(*args, *settings)
        with perf.span("track.solve_capture"):   # from a fresh stream
            self.graph, = cuda_graphs.capture(
                [solve], torch.cuda.Stream(inputs[0].device), warmup=True)

    def __call__(self, inputs):
        for dst, src in zip(self.static, inputs):
            dst.copy_(src)
        self.graph.replay()
        return self.pose10.clone(), self.p2p.clone()


def icp_solve_all_levels(pose10, vertex1_pyr, vertex0_pyr, normal1_pyr,
                         normal0_pyr, K, downscales, iters, damping: float,
                         distance_threshold: float, normal_threshold: float,
                         association: str):
    """Coarse-to-fine GN over every pyramid level, then the failure metric
    (``icp_solve_all_levels`` :164).  Returns (pose10, p2p loss).

    On a CUDA device the first solve of each key is captured as a CUDA
    graph (span ``track.solve_capture``) and every later one replays it
    (``track.solve_replay``): the same kernels, one launch.  CPU tensors
    run eager."""
    settings = (tuple(float(s) for s in downscales), tuple(int(n) for n in iters),
                float(damping), float(distance_threshold),
                float(normal_threshold), str(association))
    with perf.span("track.solve"):
        if pose10.device.type == "cuda":
            inputs = (pose10, *vertex1_pyr, *vertex0_pyr, *normal1_pyr,
                      *normal0_pyr, K)
            key = cuda_graphs.replay_key(inputs, settings)
            graph = _graphs.get(key)
            if graph is not None:
                with perf.span("track.solve_replay"):
                    return graph(inputs)
            graph = _graphs.add(key, lambda: _SolveGraph(inputs, settings))
            if graph is not None:
                return graph(inputs)
        return _solve(pose10, vertex1_pyr, vertex0_pyr, normal1_pyr,
                      normal0_pyr, K, *settings)


def build_icp_pyramids(depth: torch.Tensor, K: torch.Tensor, levels: int):
    """Depth -> per-level (vertex, normal) maps from the max-pooled depth
    pyramid with per-level intrinsics (``build_icp_pyramids`` :211)."""
    vertex, normal = [], []
    for i, d in enumerate(preprocess.depth_pyramid(depth, levels)):
        Ks = level_intrinsics(K, 1.0 / (1 << (levels - 1 - i)))
        vm = preprocess.compute_vertex_map(d, Ks)
        vertex.append(vm)
        normal.append(preprocess.compute_normal_map(vm))
    return vertex, normal


class IcpTracker:
    """Pyramid ICP front-end (``IcpTracker`` :226, reference icp.py:357-452):
    the settings both tracking paths read, and the staged path's state —
    the current and previous (or model) pyramids, the constant-velocity
    prior and the failure gate of :meth:`predict_pose`."""

    def __init__(self, args):
        self.downscales = list(args.icp_downscales)
        self.iters = list(args.icp_downscale_iters)
        self.levels = len(self.downscales)
        self.damping = float(args.icp_damping)
        self.distance_threshold = float(args.icp_distance_threshold)
        self.normal_threshold = float(np.cos(np.deg2rad(args.icp_normal_threshold)))
        self.sample_distance_threshold = float(args.icp_sample_distance_threshold)
        self.sample_normal_threshold = float(args.icp_sample_normal_threshold)
        self.fail_threshold = float(args.icp_fail_threshold)
        self.use_model_depth = bool(args.icp_use_model_depth)
        self.warmup_frames = int(args.icp_warmup_frames)
        self.association = str(getattr(args, "icp_association", "bilinear"))
        # constant-velocity prior: seed each solve with the last relative pose
        self.use_motion_model = str(getattr(
            args, "icp_initializer", "constant_velocity")) == "constant_velocity"
        self.last_rel = np.eye(4, dtype=np.float32)
        self.prior_valid = False
        self.frame_count = 0

        self.K = None
        self.vertex_t0 = None
        self.normal_t0 = None
        self.vertex_t1 = None
        self.normal_t1 = None
        self.depth_t1 = None
        self.last_model_depth = None

    # -- per-frame state (the staged tracking path) -------------------------
    def update_curr_status(self, depth_t1: torch.Tensor, K: torch.Tensor) -> None:
        """The current frame's depth and pyramids (``update_curr_status``
        :265)."""
        if self.K is None:
            self.K = K.to(torch.float32)
        self.depth_t1 = depth_t1
        self.vertex_t1, self.normal_t1 = build_icp_pyramids(
            depth_t1, self.K, self.levels)

    def move_last_status(self) -> None:
        """The current frame becomes the next solve's target (:272)."""
        self.vertex_t0 = self.vertex_t1
        self.normal_t0 = self.normal_t1
        self.last_model_depth = self.depth_t1

    def update_last_status(self, render_depth, frame_depth, render_normal,
                           frame_normal) -> None:
        """Fuse the rendered model depth with the sensor depth for the next
        frame's target pyramid (:277, reference icp.py:397-415)."""
        self.last_model_depth = fuse_model_depth(
            render_depth, frame_depth, render_normal, frame_normal,
            self.sample_distance_threshold, self.sample_normal_threshold)

    # -- pose estimation ----------------------------------------------------
    def predict_pose(self):
        """The relative pose T_{t0<-t1} and a success flag (``predict_pose``
        :285).  One device-to-host fetch (pose and residual) per solve; the
        failure gate decides on the host:

        * no trusted prior yet (first solve) -> accept and seed the prior;
        * a failed residual test while the solve stayed near the
          constant-velocity prediction -> accept (the unmasked residual
          inflates at depth edges);
        * a failed test with a solve that jumped away from the prediction ->
          a HARD failure: return the prediction and False, so the caller can
          relocalize or fall back to feature tracking."""
        if self.vertex_t0 is None:
            return np.eye(4), True
        self.frame_count += 1
        if (self.use_model_depth and self.last_model_depth is not None
                and self.frame_count >= self.warmup_frames):
            self.vertex_t0, self.normal_t0 = build_icp_pyramids(
                self.last_model_depth, self.K, self.levels)
        dev = self.K.device
        with perf.span("track.prior_upload"):
            pose10 = torch.as_tensor(
                self.last_rel if self.use_motion_model
                else np.eye(4, dtype=np.float32), device=dev)
        pose10, p2p = icp_solve_all_levels(
            pose10, self.vertex_t1, self.vertex_t0, self.normal_t1,
            self.normal_t0, self.K, [float(s) for s in self.downscales],
            self.iters, self.damping, self.distance_threshold,
            self.normal_threshold, self.association)
        with perf.span("track.solve_fetch"):
            host = torch.cat([pose10.reshape(-1), p2p.reshape(1)]).cpu().numpy()
        pose_np = host[:16].reshape(4, 4).astype(np.float32)
        success = bool(host[16] <= self.fail_threshold)
        if not success and self.use_motion_model:
            if not self.prior_valid:
                self.last_rel = pose_np
                self.prior_valid = True
                return pose_np, True
            delta = np.linalg.norm(pose_np[:3, 3] - self.last_rel[:3, 3])
            cosang = np.clip(
                (np.trace(pose_np[:3, :3].T @ self.last_rel[:3, :3]) - 1) / 2,
                -1, 1)
            ang = np.degrees(np.arccos(cosang))
            if delta > 0.01 or ang > 1.0:
                return np.asarray(self.last_rel), False
            self.last_rel = pose_np
            return pose_np, True
        if success:
            self.last_rel = pose_np
            self.prior_valid = True
        else:
            self.last_rel = np.eye(4, dtype=np.float32)
        return pose_np, success

    def reset_prior(self, rel: np.ndarray) -> None:
        """Re-seed the constant-velocity prior after an external pose fix
        (relocalization or a backend correction)."""
        self.last_rel = np.asarray(rel, np.float32)
        self.prior_valid = True


def fuse_model_depth(render_depth, frame_depth, render_normal, frame_normal,
                     sample_distance_threshold: float,
                     sample_normal_threshold: float) -> torch.Tensor:
    """Fill model-rendered depth with sensor depth where the model disagrees
    or is empty (``fuse_model_depth`` :347, reference icp.py:397-415)."""
    rd = render_depth[..., 0] if render_depth.ndim == 3 else render_depth
    fd = frame_depth[..., 0] if frame_depth.ndim == 3 else frame_depth
    cos = torch.sum(render_normal * frame_normal, dim=-1) / (
        torch.linalg.norm(render_normal, dim=-1)
        * torch.linalg.norm(frame_normal, dim=-1) + 1e-8)
    normal_mask = (1.0 - cos) > sample_normal_threshold
    fill = ((torch.abs(rd - fd) > sample_distance_threshold) | (rd == 0)
            | normal_mask) & (fd > 0)
    return torch.where(fill, fd, rd)[..., None]
