"""Loop detection + geometric verification for the pose backend.

Port of ``rtgslam_tpu/slam/loop_closure.py``.  The reference gets loop
closure from its ORB-SLAM2 backend (DBoW2 place recognition + pose-graph
optimization, ``thirdParty/ORB-SLAM2-PYBIND``; the corrected trajectory is
re-applied by ``mapper.update_poses``, mapper.py:134-141).  Here detection
runs on the host:

  1a. pose gate: an earlier record whose estimated camera centre is within
      ``radius`` metres, whose viewing direction agrees within
      ``angle_deg``, and which is at least ``min_gap`` frames old;
  1b. appearance gate (the DBoW2 role): a global per-record descriptor
      (illumination-normalized grayscale thumbnail + scale-normalized depth
      thumbnail) matched by cosine similarity against the whole store; it
      never consults the estimated pose, so a loop whose drift exceeds the
      pose gate is still found, and its ICP verification also starts from
      an identity seed;
  2.  geometric verification: the port's ICP pyramid solve
      (``ops/icp.py``) on the tracker's device aligns the candidate's stored
      depth with the current one; the point-to-plane residual accepts or
      rejects;
  3.  the caller feeds ``(i, j, T_ij)`` to the backend's
      ``add_loop_constraint`` (or ``relax_pose_graph`` on the fused path).

Records hold a full-resolution depth map each in host RAM (~1.2 MB at
480x640); ``loop_max_records`` bounds the store.  Depth goes to the device
only for verification.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.icp import build_icp_pyramids, icp_solve_all_levels
from ..utils import perf

# global-descriptor thumbnail grid (rows, cols); 384-dim descriptor
_DESC_SHAPE = (12, 16)


def _thumbnail(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Block-mean downsample [H, W] -> [th, tw] (crop to multiples)."""
    H, W = img.shape[:2]
    hs, ws = max(H // th, 1), max(W // tw, 1)
    th, tw = min(th, H), min(tw, W)
    crop = img[: hs * th, : ws * tw]
    return crop.reshape(th, hs, tw, ws).mean(axis=(1, 3))


def _descriptor(color: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """Unit-norm global appearance descriptor (``_descriptor`` :63):
    zero-mean / unit-norm grayscale thumbnail + zero-mean / unit-norm depth
    thumbnail, the role of the reference's DBoW2 image signature."""
    th, tw = _DESC_SHAPE
    gray = color.mean(axis=-1) if color.ndim == 3 else color
    parts = []
    for img in (gray.astype(np.float32), depth.astype(np.float32)):
        t = _thumbnail(img, th, tw).ravel()
        t -= t.mean()
        t /= np.linalg.norm(t) + 1e-8
        parts.append(t)
    return np.concatenate(parts) / np.sqrt(2.0)


def _host_depth(depth_map) -> np.ndarray:
    """[H, W] float32 host copy of a depth map (tensor or array, [H, W] or
    [H, W, 1])."""
    if torch.is_tensor(depth_map):
        with perf.span("track.depth_fetch"):
            depth_map = depth_map.detach().cpu().numpy()
    depth = np.asarray(depth_map, np.float32)
    return depth[..., 0] if depth.ndim == 3 else depth


class LoopCloser:
    def __init__(self, args, device):
        self.device = torch.device(device)
        self.every = int(getattr(args, "loop_check_every", 5))
        self.min_gap = int(getattr(args, "loop_min_gap", 30))
        self.radius = float(getattr(args, "loop_candidate_radius", 0.4))
        self.angle_deg = float(getattr(args, "loop_candidate_angle", 30.0))
        # appearance gate: min cosine similarity; <= 0 disables it
        self.appearance_sim = float(getattr(args, "loop_appearance_sim", 0.92))
        self.p2p_accept = float(getattr(args, "loop_p2p_accept",
                                        getattr(args, "icp_fail_threshold", 5e-5)))
        self.min_valid_depth = 0.05   # reject views with no geometry
        self.cooldown = int(getattr(args, "loop_cooldown", 20))
        # relocalization accepts a looser residual than loop closure: the
        # seed pose is already known-bad, convergence basin matters more
        self.reloc_accept = float(getattr(args, "reloc_p2p_accept",
                                          4.0 * self.p2p_accept))

        self.downscales = [float(s) for s in args.icp_downscales]
        self.iters = list(args.icp_downscale_iters)
        self.levels = len(self.downscales)
        self.damping = float(args.icp_damping)
        self.distance_threshold = float(args.icp_distance_threshold)
        self.normal_threshold = float(np.cos(np.deg2rad(args.icp_normal_threshold)))
        self.association = str(getattr(args, "icp_association", "bilinear"))

        # at the cap the store is thinned to every other record and the
        # sampling stride doubles: the whole trajectory stays covered
        self.max_records = int(getattr(args, "loop_max_records", 256))
        self.records: List[Dict] = []
        self._last_closure = -(10 ** 9)

    # ------------------------------------------------------------------
    def observe(self, frame_id: int, c2w_est: np.ndarray, depth_map, K,
                color_map=None) -> Optional[Tuple[int, int, np.ndarray]]:
        """Record the frame (every ``every`` frames) and return a verified
        loop ``(i, j, T_ij)`` with ``T_ij = c2w_i^-1 c2w_j``, or None
        (``observe`` :120).  ``color_map`` ([H, W, 3] host array) enables
        the appearance detector."""
        if frame_id % self.every != 0:
            return None
        depth_np = _host_depth(depth_map)
        rec = {"id": frame_id, "c2w": np.asarray(c2w_est, np.float64),
               "depth": depth_np,
               "valid": float((depth_np > 0).mean()),
               "desc": None if color_map is None else _descriptor(
                   np.asarray(color_map, np.float32), depth_np)}
        result = None
        if rec["valid"] >= self.min_valid_depth \
                and frame_id - self._last_closure >= self.cooldown:
            cand, seeds = self._best_candidate(rec), ("est",)
            if cand is None:
                # the pose gate found nothing (drift may exceed the radius):
                # place recognition with a drift-independent seed
                cand = self._best_appearance(rec)
                seeds = ("est", "identity")
            if cand is not None:
                T_ij, p2p = self._verify(cand, rec, K, seeds)
                if p2p <= self.p2p_accept:
                    self._last_closure = frame_id
                    result = (cand["id"], frame_id, T_ij)
        self.records.append(rec)
        if len(self.records) > self.max_records:
            self.records = self.records[::2]
            self.every *= 2
        return result

    def update_poses(self, corrected: List[np.ndarray]) -> None:
        """Re-anchor the stored records after a pose-graph relaxation
        (``update_poses`` :159): a later ``relocalize`` would otherwise
        re-inject the drift the closure removed."""
        n = len(corrected)
        for rec in self.records:
            if rec["id"] < n:
                rec["c2w"] = np.asarray(corrected[rec["id"]], np.float64)

    # ------------------------------------------------------------------
    def _best_candidate(self, rec) -> Optional[Dict]:
        best, best_d = None, np.inf
        c = rec["c2w"][:3, 3]
        view = rec["c2w"][:3, 2]
        cos_thresh = np.cos(np.deg2rad(self.angle_deg))
        for old in self.records:
            if rec["id"] - old["id"] < self.min_gap:
                continue
            if old["valid"] < self.min_valid_depth:
                continue
            d = np.linalg.norm(old["c2w"][:3, 3] - c)
            if d > self.radius or d >= best_d:
                continue
            if float(old["c2w"][:3, 2] @ view) < cos_thresh:
                continue
            best, best_d = old, d
        return best

    def _best_appearance(self, rec) -> Optional[Dict]:
        """Place recognition: the best cosine-similarity record above the
        gate; never consults the estimated pose."""
        if rec["desc"] is None or self.appearance_sim <= 0:
            return None
        best, best_s = None, self.appearance_sim
        for old in self.records:
            if rec["id"] - old["id"] < self.min_gap:
                continue
            if old["valid"] < self.min_valid_depth or old["desc"] is None:
                continue
            s = float(old["desc"] @ rec["desc"])
            if s > best_s:
                best, best_s = old, s
        return best

    def relocalize(self, frame_id: int, c2w_guess: np.ndarray, depth_map, K,
                   max_candidates: int = 3, color_map=None) -> Optional[np.ndarray]:
        """The camera pose after a tracking failure, by ICP-aligning the
        current depth against the nearest stored records (and, with
        ``color_map``, the best appearance match); None if no candidate
        aligns within ``reloc_accept`` (``relocalize`` :206; the reference
        relocalizes through ORB-SLAM2, tracker.py:236-244)."""
        depth_np = _host_depth(depth_map)
        if (depth_np > 0).mean() < self.min_valid_depth:
            return None
        c = np.asarray(c2w_guess, np.float64)[:3, 3]
        cands = sorted(
            (r for r in self.records if r["valid"] >= self.min_valid_depth),
            key=lambda r: np.linalg.norm(r["c2w"][:3, 3] - c))
        rec = {"id": frame_id, "c2w": np.asarray(c2w_guess, np.float64),
               "depth": depth_np,
               "desc": None if color_map is None else _descriptor(
                   np.asarray(color_map, np.float32), depth_np)}
        trials = [(cand, ("est",)) for cand in cands[:max_candidates]]
        app = self._best_appearance(dict(rec, id=10 ** 9)) \
            if rec["desc"] is not None else None
        if app is not None and all(c is not app for c, _ in trials):
            trials.append((app, ("est", "identity")))
        best_pose, best_p2p = None, np.inf
        for cand, seeds in trials:
            T_ij, p2p = self._verify(cand, rec, K, seeds)
            if p2p <= self.reloc_accept and p2p < best_p2p:
                best_pose, best_p2p = cand["c2w"] @ T_ij, p2p
        return best_pose

    def _verify(self, cand, rec, K,
                seeds: Tuple[str, ...] = ("est",)) -> Tuple[np.ndarray, float]:
        """ICP-align the current depth (t1) against the candidate's (t0) on
        the device; the lowest-residual (refined T_ij, residual) over the
        seeds (``_verify`` :245).  ``"est"`` seeds from the estimates,
        ``"identity"`` from T_ij = I (the basin of an appearance match)."""
        dev = self.device
        with perf.span("track.depth_upload"):
            K = (K.to(device=dev, dtype=torch.float32) if torch.is_tensor(K)
                 else torch.as_tensor(np.asarray(K, np.float32), device=dev))
            d0 = torch.as_tensor(cand["depth"], device=dev)
            d1 = torch.as_tensor(rec["depth"], device=dev)
        v0, n0 = build_icp_pyramids(d0, K, self.levels)
        v1, n1 = build_icp_pyramids(d1, K, self.levels)
        best = (np.eye(4), np.inf)
        for kind in seeds:
            seed = (np.linalg.inv(cand["c2w"]) @ rec["c2w"] if kind == "est"
                    else np.eye(4))
            with perf.span("track.prior_upload"):
                seed = torch.as_tensor(seed, dtype=torch.float32, device=dev)
            pose10, p2p = icp_solve_all_levels(
                seed, v1, v0, n1, n0, K, self.downscales, self.iters,
                self.damping, self.distance_threshold, self.normal_threshold,
                self.association)
            # one fetch: the pose and its residual
            with perf.span("track.solve_fetch"):
                host = torch.cat([pose10.reshape(-1),
                                  p2p.reshape(1)]).cpu().numpy()
            p2p = float(host[16])
            if p2p < best[1]:
                best = (host[:16].reshape(4, 4).astype(np.float64), p2p)
        return best
