"""The work a blend launch's data needs, and the least time the card could
take for it: the yardstick of the kernels' roofline shares.

A frozen copy of ``chip_smoke.py``'s ``live_work`` / ``work_bound`` and of
the alpha arithmetic they rest on (``ops/rasterize/blend.py``'s
``_chunk_alphas`` and ``tile_pixels``), so a later change to the program
cannot move the yardstick.  Operations are FP32 operations counted from the
kernels' sources (a fused multiply-add counts 2, expf 1), charged only
where the launch's data needs them; bytes count each input read once and
each output written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

TILE = 16
NPIX = TILE * TILE
CHUNK = 128
ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99
NFEAT = 11
# every live (pixel, entry) pair needs its alpha: the power, the clamp,
# expf, the opacity product and 3 threshold tests
ALPHA_OPS = 17
# a pair with a non-zero alpha needs more.  K1: the weight, 3 colour FMAs,
# 3 compares, the transmittance FMA; in transmission mode the FMA alone
K1_BLEND_OPS, K1_TRANS_OPS = 12, 2
# K2: rgb . g_C 5, the weight 1, prefix and suffix sums 4, d/dalpha 5, the
# gate's and the depth hit's compares 3, the alpha factor 1, the ten terms
# 20, T 2, and 9 adds into the entry's pixel sums
K2_TERM_OPS = 50
# one NVIDIA H100 SXM at its 700 W limit: dense FP32 outside the tensor
# cores and HBM3 bandwidth (NVIDIA's data sheet)
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12


def tile_pixels(origins: torch.Tensor) -> torch.Tensor:
    """[T, 256, 2] pixel centres' coordinates of each tile's pixels."""
    ij = torch.arange(NPIX, device=origins.device)
    local = torch.stack([(ij % TILE), (ij // TILE)], dim=-1).to(origins.dtype)
    return origins[:, None, :] + local[None]


def chunk_alphas(f: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """alpha [A, 256, C] of entries ``f`` [A, C, 11 or 6 columns] at the
    tiles' pixels ``pix`` [A, 256, 2]."""
    opa = f[:, None, :, 9] if f.shape[-1] == NFEAT else f[:, None, :, 5]
    dx = pix[:, :, 0, None] - f[:, None, :, 0]
    dy = pix[:, :, 1, None] - f[:, None, :, 1]
    power = -0.5 * (f[:, None, :, 2] * dx * dx + f[:, None, :, 4] * dy * dy) \
        - f[:, None, :, 3] * dx * dy
    raw = opa * torch.exp(torch.clamp(power, max=0.0))
    return torch.where((power > 0) | (raw < ALPHA_EPS), 0.0,
                       torch.clamp(raw, max=ALPHA_MAX))


def live_work(feat, lists, counts, done, origins) -> Dict[str, int]:
    """What a launch's data needs: ``pairs``, the live (pixel, entry) pairs
    256 x sum_t min(count_t, chunk x done_t) that a walk stopped at the
    count computes; ``nonzero``, those with a non-zero alpha;
    ``positions``, the list entries they read; ``rows``, the distinct
    feature rows those entries name (the sentinel left out); ``chunks``,
    sum_t done_t; ``tiles``, the tiles with a live position."""
    T, Kt = lists.shape
    chunk = min(CHUNK, Kt)
    V = feat.shape[0] - 1
    n = torch.minimum(counts.long().clamp(0, Kt), chunk * done.long())
    live = torch.arange(Kt, device=lists.device)[None] < n[:, None]
    entries = lists[live]
    pix = tile_pixels(origins)
    nonzero = 0
    for c in range(int(done.max()) if T else 0):
        cols = slice(c * chunk, (c + 1) * chunk)
        for a in torch.nonzero(done > c).squeeze(1).split(256):
            alpha = chunk_alphas(feat[lists[a, cols].long()], pix[a])
            nonzero += int(((alpha != 0) & live[a, None, cols]).sum())
    return {"pairs": NPIX * int(n.sum()), "nonzero": nonzero,
            "positions": int(n.sum()),
            "rows": int(torch.unique(entries[(entries >= 0) & (entries < V)]).numel()),
            "chunks": int(done.long().sum()), "tiles": int((n > 0).sum())}


def bound(flops: float, n_bytes: float) -> Tuple[float, str]:
    """(ms, what sets it): the least time the card could take for ``flops``
    FP32 operations that move ``n_bytes``."""
    t_ops, t_bytes = flops / PEAK_FP32, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def work_bound(kind: str, w: Dict[str, int], T: int, n_chunks: int) -> Tuple[float, str]:
    """(ms, what sets it) of a launch of ``kind`` ("inference",
    "residual", "transmission" or "bwd") on ``T`` tiles of ``n_chunks``
    chunks, from :func:`live_work`'s counts ``w``."""
    rows, pos = w["rows"], w["positions"]
    if kind == "transmission":   # 6-column rows in, T out
        return bound(w["pairs"] * ALPHA_OPS + w["nonzero"] * K1_TRANS_OPS,
                     24 * rows + 4 * pos + 12 * T + 4 * NPIX * T)
    read = 48 * rows + 4 * pos + 12 * T      # rows, lists, counts, origins
    if kind == "bwd":
        # done; the processed chunks' entry T and chunk colours; the live
        # tiles' cotangents, T_final x g_T and depth hits; 10 partials out
        # per position
        return bound(w["pairs"] * ALPHA_OPS + w["nonzero"] * K2_TERM_OPS,
                     read + 4 * T + 16 * NPIX * w["chunks"]
                     + 24 * NPIX * w["tiles"] + 40 * pos)
    out = 36 * NPIX * T   # colour, depth, T, index maps and weights
    if kind == "residual":   # entry T of every chunk, done, chunk colours
        out += 4 * NPIX * T * n_chunks + 4 * T + 12 * NPIX * w["chunks"]
    return bound(w["pairs"] * ALPHA_OPS + w["nonzero"] * K1_BLEND_OPS,
                 read + out)
