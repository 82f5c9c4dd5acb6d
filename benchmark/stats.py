"""The arithmetic of the end-to-end metrics and of the trace's digest."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it (p90 of 100 values is the 90th
    smallest)."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    n = len(ordered)
    if n == 0:
        raise ValueError("median of no values")
    mid = n // 2
    return ordered[mid] if n % 2 else 0.5 * (ordered[mid - 1] + ordered[mid])


def fps(n_frames: int, window_s: float) -> float:
    """Frames completed in the window over the window's wall seconds, the
    end-of-session passes inside it included in the seconds."""
    if window_s <= 0:
        raise ValueError("a window of no time")
    return n_frames / window_s


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by possibly overlapping [start, end) intervals."""
    return sum(e - s for s, e in merge(intervals))


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, disjoint cover of the intervals (empty ones dropped)."""
    out: List[List[float]] = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(intervals: Iterable[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The parts of [start, end) that no interval covers."""
    out, cursor = [], start
    for s, e in merge(intervals):
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if end > cursor:
        out.append((cursor, end))
    return out


def horn_align(est: np.ndarray, gt: np.ndarray):
    """Rotation R, translation t and scale 1 minimising |R est + t - gt|
    over point sets [N, 3] (Horn's closed form, through the SVD)."""
    mu_e, mu_g = est.mean(axis=0), gt.mean(axis=0)
    E, G = est - mu_e, gt - mu_g
    U, _, Vt = np.linalg.svd(G.T @ E)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_g - R @ mu_e


def position_errors_m(est_c2w: np.ndarray, gt_c2w: np.ndarray) -> np.ndarray:
    """Per-frame camera-position errors (metres) after aligning the
    estimated positions to the ground truth."""
    est, gt = est_c2w[:, :3, 3], gt_c2w[:, :3, 3]
    R, t = horn_align(est, gt)
    return np.linalg.norm(est @ R.T + t - gt, axis=1)


def rotation_errors_deg(est_c2w: np.ndarray, gt_c2w: np.ndarray) -> np.ndarray:
    """Per-frame camera-orientation errors (degrees) of trajectories that
    share their first frame's coordinates (the tracker starts at the
    identity, the ground truth is normalised to its first pose).  No
    alignment: over a short, nearly straight path the position alignment
    leaves the rotation about the path free."""
    rel = np.einsum("nji,njl->nil", gt_c2w[:, :3, :3], est_c2w[:, :3, :3])
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(cos))


def ate_rmse_cm(est_c2w: np.ndarray, gt_c2w: np.ndarray) -> float:
    """ATE RMSE (cm) of the aligned camera positions."""
    err = position_errors_m(est_c2w, gt_c2w)
    return float(np.sqrt(np.mean(err * err)) * 100.0)


def psnr(render: np.ndarray, target: np.ndarray) -> float:
    """PSNR (dB) of a render clamped to [0, 1] against a target in [0, 1]."""
    diff = np.clip(render.astype(np.float64), 0.0, 1.0) - target.astype(np.float64)
    mse = float(np.mean(diff * diff))
    return float("inf") if mse == 0 else -10.0 * math.log10(mse)
