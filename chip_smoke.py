#!/usr/bin/env python3
"""Drive the PyTorch port (``rtgslam_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and nothing falls back to the CPU):
  1.  require a CUDA device; print the card's name and power limit;
  2.  build kernels K1 (csrc/blend_fwd.cu) and K2 with its reduce
      (csrc/blend_bwd.cu; both include csrc/blend_common.cuh) from the
      sources, one nvcc each, started together, and print the seconds and
      ptxas's registers and shared memory; build the pose backend
      (csrc/pose_backend.cc) with g++;
  3a. hold K1's inference mode against its plain PyTorch twin on random
      tiles, some of whose counts sit at the walks' trim edges (0, 1,
      chunk - 1, chunk, chunk + 1, Kt);
  3c. K1's residual mode (maps, entry T, done, chunk colours) and
      transmission mode (T, the mask T != 1 exact) against their twins on
      the same tiles;
  3d. K2 with the reduce against the plain backward on the same tiles,
      twice, bitwise equal;
  4.  the forward-only loop (both iteration counts 0) at 170x300 x 12
      frames against the JAX-on-CPU reference tests/data/slice_170x300_jax_cpu.json;
  4b. the loop with gradient optimization (bench.make_args unchanged) at
      170x300 x 12 frames against tests/data/slice_opt_170x300_jax_cpu.json;
  5.  the bench point with optimization at 680x1200 x 12 frames (map
      capacity 2^19) with the launch counts reset just before: overflow 0,
      finite metrics, ATE <= 1 cm, PSNR >= 27.5, K1 launched at least once
      per render and per iteration, K2 and the reduce once per iteration;
      the run keeps the inputs of the first K1 residual and K2 launches of
      its last local optimize call and of its final pass, and times every
      optimize call;
  3b. K1's inference mode against its twin on that map's last frame;
  3e. K1's transmission mode against its twin on the stable pool's mask
      render of that map, and K1's residual mode, K2 and the reduce against
      theirs on the launches phase 5 kept (the local pass's compact lists,
      the final pass's full lists); K2 with the reduce launched twice on
      each, bitwise equal;
  6a. the entry points, slam_torch.py then metric_torch.py, on the room
      written to disk at 170x300 x 12 frames (a child of
      configs/synthetic/room.yaml whose keyframe thresholds put the windowed
      global optimization on the path) against the JAX package's slam.py +
      metric.py on the CPU, tests/data/entry_170x300_jax_cpu.json: ATE, PSNR,
      depth L1, checkpoint rows, the checkpoint and trajectory file sets and
      the metric CSV;
  6b. the entry points on phase 5's 12 frames written to disk at 680x1200
      (a child of configs/synthetic/room_full.yaml, full frames), with the
      launch counts reset just before: overflow 0, ATE <= 1 cm, PSNR >= 27.5,
      a windowed global call, K1's residual mode and K2 launched at least
      once per iteration; the final checkpoint, reloaded into a fresh
      mapper, renders the last keyframe within 0.01 dB of the in-run eval;
      metric_torch writes a CSV row per frame and the mean; K1's residual
      mode, K2 and the reduce against their twins on the global call's own
      launches, K2 with the reduce twice, bitwise equal;
  7a. the TUM operating point (configs/tum_base.yaml's tracking and mapping
      keys, tests/torch_parity.py::TUM_KEYS: the staged tracking path through
      the native pose backend, loop detection, the depth filter, a gradient
      pass every 4th frame): slam_torch.py + metric_torch.py on phase 6a's
      room on disk against tests/data/entry_orb_170x300_jax_cpu.json; then
      at TUM's 480x640, 12 frames out and 11 back with a check every frame:
      ATE <= 1 cm, PSNR >= 27.5, overflow 0, a loop closed, the split of the
      tracking time (ICP, backend, loop check), K1 and K2 on the run's own
      launches against their twins;
  7b. slam_mp_torch.py (tracker and mapper threads, each on its own CUDA
      stream): at 170x300 with strict sync every frame, twice (equal ATE,
      PSNR and rows) and against tests/data/mp_170x300_jax_cpu.json; at
      680x1200 on phase 6b's scene with the config's strict / 5 and then
      free: ATE, PSNR, overflow as in 6b, mid-run checkpoints, the tracking,
      mapping and wall time per frame against 6b's single-process run;
  7c. frozen binning (optimize_compact off, optimize_freeze_binning on): one
      local call over phase 5's final map and frame memory, its first K1
      residual and K2 launches against their twins, the ms per iteration and
      the loss of its first and last iteration.
Phases 7b and 7c run before 7a.
Each of phases 5, 6b, 7a, 7b and 7c resets the launch counts just before
its runs and reads them just after, and fails if a kernel its path runs was
not launched there.
For every launch measured in 3b, 3e, 6b and 7a-7c the script prints the live
(pixel, entry) pairs its inputs need and how many of them have a non-zero
alpha, the least time the card could take for that work (the bound: FP32
operations over 67 TFLOP/s or bytes over 3.35 TB/s, whichever is larger;
the operations charged per pair as the data needs them, the bytes of the
rows and list entries the walks read and of the outputs), the kernel's
CUDA-event time and its share of the bound; for K2's launches also the
time of the reduce's row index.
The line before the last is the kernel report, the last the device line.
"""

import copy
import csv
import inspect
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REF_170 = os.path.join(REPO, "tests", "data", "slice_170x300_jax_cpu.json")
REF_OPT_170 = os.path.join(REPO, "tests", "data", "slice_opt_170x300_jax_cpu.json")
REF_ENTRY_170 = os.path.join(REPO, "tests", "data", "entry_170x300_jax_cpu.json")
REF_ORB_170 = os.path.join(REPO, "tests", "data", "entry_orb_170x300_jax_cpu.json")
REF_MP_170 = os.path.join(REPO, "tests", "data", "mp_170x300_jax_cpu.json")
ROOM_FULL_YAML = os.path.join(REPO, "configs", "synthetic", "room_full.yaml")
# phase 7a at TUM's sensor size: 12 frames out and 11 back, the revisit of
# tests/test_loop_closure.py::_loop_sequence, checked for loops every frame;
# the in-memory frames carry TUM's depth factor (5000 per metre), which the
# pose backend's 16-bit depth needs (at a factor of 1 it would see whole
# metres)
TUM_H, TUM_W, LOOP_OUT = 480, 640, 12
TUM_DEPTH_SCALE = 5000.0
LOOP_KEYS = {"loop_check_every": 1, "loop_min_gap": 10}
KERNELS = ("blend_fwd", "blend_fwd_residual", "blend_fwd_transmission",
           "blend_bwd", "blend_bwd_reduce")
# phase 6b's child of room_full.yaml (30 iterations on frames 0, 5, 11): the
# keyframe thresholds of the 170x300 reference make every optimization
# frame a keyframe, and a gaussian optimized in both calls before frame 11
# (confidence up to 60) passes the stable threshold, so frame 11 runs the
# windowed global optimization
FULL_OVERRIDES = {"keyframe_trans_thes": 0.003, "keyframe_theta_thes": 0.25,
                  "stable_confidence_thres": 40, "save_step": 6}
# the reloaded final checkpoint against the in-run eval of the last keyframe
RELOAD_PSNR_DB = 0.01
FRAMES = 12
# K1 vs the plain twin: sequential vs log-space transmittance, rounding only
BLEND_ATOL = 1e-5
# index maps may differ only where the plain twin and K1 round a tie
# differently; such pixels must stay this rare
TIE_FRACTION = 1e-3
# K2 vs the plain backward, column by column: each column within BWD_RTOL
# of its own largest gradient, plus BWD_FLOOR of the largest gradient of
# any column (for a column that is all but 0).  Per-pixel terms are summed
# in another order (a warp butterfly, then the warps, then the tiles in
# list order; PyTorch's own order in the twin) on transmittances that
# differ by rounding
BWD_RTOL, BWD_FLOOR = 1e-4, 1e-6
# the reduce vs its twin: both add each row's positions in the same order
REDUCE_ATOL = 0.0
BWD_COLUMNS = ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "z",
               "r", "g", "b", "opacity")
# phase 4 against the JAX reference: the port replays JAX's spawn priority
# stream (utils/threefry.py), so both sample the same pixels; what is left
# is float rounding (GPU vs CPU, sequential vs log-space transmittance),
# which can flip a threshold test at a few pixels
REF_TOL = {"ate_cm": 0.05, "psnr": 0.2, "depth_l1_cm": 0.1, "gaussians_rel": 0.01}
# phase 4b: the same, with 150 Adam iterations and 10 final-pass ones in
# between.  Adam (eps 1e-15) turns rounding differences into lr-sized steps,
# so the maps differ elementwise; on the CPU the port came within 0.004 cm
# ATE, 0.02 dB PSNR, 0.005 cm depth L1 and 0.5 % gaussians of the reference
OPT_REF_TOL = {"ate_cm": 0.05, "psnr": 0.3, "depth_l1_cm": 0.1,
               "gaussians_rel": 0.02}
# phase 6a: OPT_REF_TOL, except the final keyframe's PSNR.  That one frame,
# rendered after the windowed global call and the final pass, moved with the
# summation order while K2 added with atomics: six runs on one H100 gave
# 34.51-35.05 dB against the reference's 35.03.  K2 now sums in a fixed
# order and the run repeats bit for bit, so what is left is one fixed gap;
# the metric CSV's mean PSNR over all 12 frames is held to OPT_REF_TOL's 0.3
ENTRY_REF_TOL = dict(OPT_REF_TOL, final_psnr=0.8)
# phase 7a at 170x300 (the TUM keys: depth filter, confidence 0.5, a gradient
# pass every 4th frame, poses refined by the pose backend): ENTRY_REF_TOL,
# except the final keyframe's PSNR.  Four runs of the port sit 0.89-1.04 dB
# below the JAX reference's 30.807 (an H100: 29.873; the CPU at 1, 3 and 6
# threads, tests/torch_parity.py --port --entry --orb: 29.912, 29.886,
# 29.767) while their poses agree within 2.6e-4 and the metric CSV's mean
# PSNR over all 12 frames within 0.26 dB (held to OPT_REF_TOL's 0.3)
# (ROADMAP.md, Faults)
ORB_REF_TOL = dict(ENTRY_REF_TOL, final_psnr=1.2)
BENCH_ATE_CM, BENCH_PSNR = 1.0, 27.5
# FP32 operations, counted from the sources (a fused multiply-add counts 2,
# expf 1) and charged only where the function needs them.  Every live
# (pixel, entry) pair needs its alpha (blend_common.cuh::entry_alpha): 11
# for the power, the clamp, expf, the opacity product and 3 for the
# thresholds
ALPHA_OPS = 17
# a pair with a non-zero alpha needs more (one with alpha 0 changes nothing
# and has no gradient).  K1: the weight, 3 colour FMAs, 3 compares (depth
# hit, colour index), the transmittance FMA; in transmission mode the FMA
K1_BLEND_OPS, K1_TRANS_OPS = 12, 2
# K2: rgb . g_C 5, the weight 1, the prefix and suffix sums 4, d/dalpha 5
# (its division included), the gate's and the depth hit's compares 3, the
# alpha factor 1, the ten terms 20, T 2, and 9 adds into the entry's pixel
# sums (the depth term adds only at a hit)
K2_TERM_OPS = 50
# NVIDIA H100 SXM at 700 W, dense FP32 outside the tensor cores and HBM3
# (NVIDIA's data sheet)
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps):
    """Device ms per call of ``fn`` over ``reps`` calls back to back (CUDA
    events).  A sleep kernel queued first holds the device while the host
    enqueues the calls, so a wrapper's host time (output allocations, the
    ctypes call) does not stretch a short kernel's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(int(min(2 * reps * host_s, 0.2) * 2e9))   # ~2 GHz cycles
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trim_edges(Kt):
    """Tile counts at the edges of a walk trimmed at the count."""
    chunk = min(128, Kt)
    return sorted({min(c, Kt) for c in (0, 1, chunk - 1, chunk, chunk + 1, Kt)})


def random_tiles(device, T=384, Kt=512, V=20000, seed=0):
    """Random depth-sorted feature rows and ascending per-tile lists; tiles
    1, 2, ... hold the counts of :func:`trim_edges`, the others random
    ones."""
    import torch

    g = torch.Generator().manual_seed(seed)
    tiles_x = 24
    origins = torch.stack([(torch.arange(T) % tiles_x) * 16.0,
                           (torch.arange(T) // tiles_x) * 16.0], dim=1)
    feat = torch.zeros(V + 1, 11)
    feat[:V, 0] = torch.rand(V, generator=g) * tiles_x * 16
    feat[:V, 1] = torch.rand(V, generator=g) * (T // tiles_x) * 16
    s = torch.rand(V, 2, generator=g) * 4 + 0.5
    feat[:V, 2], feat[:V, 4] = 1 / s[:, 0] ** 2, 1 / s[:, 1] ** 2
    feat[:V, 3] = (torch.rand(V, generator=g) - 0.5) * (feat[:V, 2] * feat[:V, 4]).sqrt()
    feat[:V, 5] = torch.sort(torch.rand(V, generator=g) * 5 + 0.3).values
    feat[:V, 6:9] = torch.rand(V, 3, generator=g)
    feat[:V, 9] = torch.rand(V, generator=g)
    feat[:V, 10] = (torch.rand(V, generator=g) > 0.3).float()
    order = torch.randperm(V, generator=g).to(torch.int32)
    counts = torch.randint(0, Kt + 1, (T,), generator=g).to(torch.int32)
    counts[::17] = 0
    edges = trim_edges(Kt)
    counts[1:1 + len(edges)] = torch.tensor(edges, dtype=torch.int32)
    lists = torch.full((T, Kt), V, dtype=torch.int32)
    for t in range(T):
        c = int(counts[t])
        lists[t, :c] = torch.sort(torch.randperm(V, generator=g)[:c]).values
    return [x.to(device) for x in (feat, order, lists, counts, origins)]


def random_cotangents(T, device, seed=1):
    import torch

    g = torch.Generator().manual_seed(seed)
    return [x.to(device) for x in (torch.randn(T, 256, 3, generator=g),
                                   torch.randn(T, 256, generator=g),
                                   torch.randn(T, 256, generator=g))]


def compare_blend(out, ref, feat, order, origins, opaque_threshold):
    """Max abs error of K1 against the plain twin; raises unless every
    index-map difference is a verified near-tie."""
    import torch

    npx = out.depth.numel()
    err = max(float((getattr(out, k) - getattr(ref, k)).abs().max())
              for k in ("color", "T_final", "color_weight"))
    # color index: a differing pixel must have equal maximum weights
    cdiff = out.color_index != ref.color_index
    if int(cdiff.sum()) > TIE_FRACTION * npx:
        fail(f"color_index differs at {int(cdiff.sum())} of {npx} pixels")
    if cdiff.any():
        gap = float((out.color_weight - ref.color_weight)[cdiff].abs().max())
        if gap > BLEND_ATOL:
            fail(f"color_index differs without a weight tie (gap {gap:.3g})")
    # depth hit: the earlier of the two picks sits at alpha == threshold
    ddiff = out.depth_index != ref.depth_index
    same = ~ddiff
    err = max(err, float((out.depth - ref.depth)[same].abs().max()),
              float((out.depth_weight - ref.depth_weight)[same].abs().max()))
    if int(ddiff.sum()) > TIE_FRACTION * npx:
        fail(f"depth_index differs at {int(ddiff.sum())} of {npx} pixels")
    if ddiff.any():
        V = order.shape[0]
        pos = torch.full((int(order.max()) + 2,), V, dtype=torch.long,
                         device=order.device)
        pos[order.long()] = torch.arange(V, device=order.device)
        t, p = torch.nonzero(ddiff, as_tuple=True)
        pk = pos[out.depth_index[t, p].long()]     # -1 -> V (no hit)
        pr = pos[ref.depth_index[t, p].long()]
        row = feat[torch.minimum(pk, pr)].double()
        px = origins[t, 0].double() + (p % 16).double()
        py = origins[t, 1].double() + (p // 16).double()
        dx, dy = px - row[:, 0], py - row[:, 1]
        power = -0.5 * (row[:, 2] * dx * dx + row[:, 4] * dy * dy) - row[:, 3] * dx * dy
        alpha = torch.clamp(row[:, 9] * torch.exp(power), max=0.99)
        gap = float((alpha - opaque_threshold).abs().max())
        if gap > BLEND_ATOL:
            fail(f"depth_index differs away from the opaque threshold (gap {gap:.3g})")
    if not err <= BLEND_ATOL:
        fail(f"K1 differs from the plain twin by {err:.3g} > {BLEND_ATOL}")
    return err, int(cdiff.sum()), int(ddiff.sum())


def compare_residuals(res, ref_res, t_threshold):
    """Max abs error of K1's residuals ``(entry T, done, chunk colours)``
    against the twin's: entry T over every chunk (0 past done), chunk
    colours over the chunks processed (undefined past done).  ``done`` must
    be equal except where the tile's max T at the exit test sits within
    BLEND_ATOL of the threshold (then the two round to opposite sides)."""
    import torch

    (entry, done, chunk_color), (ref_entry, ref_done, ref_cc) = res, ref_res
    diff = done != ref_done
    for t in diff.nonzero().flatten().tolist():
        c = int(min(done[t], ref_done[t]))
        edge = float(max(entry[t, c].max(), ref_entry[t, c].max()))
        if abs(edge - t_threshold) > BLEND_ATOL:
            fail(f"done differs at tile {t} ({int(done[t])} vs "
                 f"{int(ref_done[t])}) away from the exit threshold")
    same = ~diff
    err = float((entry[same] - ref_entry[same]).abs().max()) if same.any() else 0.0
    if not err <= BLEND_ATOL:
        fail(f"K1 residual entry T differs by {err:.3g} > {BLEND_ATOL}")
    reached = same[:, None] & (torch.arange(entry.shape[1], device=done.device)
                               < done[:, None])
    err_cc = (float((chunk_color[reached] - ref_cc[reached]).abs().max())
              if reached.any() else 0.0)
    if not err_cc <= BLEND_ATOL:
        fail(f"K1 residual chunk colours differ by {err_cc:.3g} > {BLEND_ATOL}")
    return max(err, err_cc), int(diff.sum())


def compare_transmission(T, ref):
    if not bool(((T != 1.0) == (ref != 1.0)).all()):
        fail("K1 transmission mode: the mask T != 1 differs from the twin's")
    err = float((T - ref).abs().max())
    if not err <= BLEND_ATOL:
        fail(f"K1 transmission mode differs by {err:.3g} > {BLEND_ATOL}")
    return err


def compare_bwd(g, ref, label):
    """K2's gradient ``g`` against the plain backward's, column by column;
    the elig column must be exactly 0.  Returns the largest error and a
    printable per-column report ``name err/largest``."""
    err = (g - ref).abs().amax(dim=0).tolist()
    scale = ref.abs().amax(dim=0).tolist()
    floor = BWD_FLOOR * max(scale)
    for i, name in enumerate(BWD_COLUMNS):
        if not err[i] <= BWD_RTOL * scale[i] + floor:
            fail(f"{label}: K2's {name} column differs from the plain backward "
                 f"by {err[i]:.3g} (largest {scale[i]:.3g}, rtol {BWD_RTOL}, "
                 f"floor {floor:.3g})")
    if float(g[:, 10].abs().max()) != 0.0:
        fail(f"{label}: K2 wrote a gradient into the elig column")
    report = ", ".join(f"{n} {e:.2g}/{s:.3g}"
                       for n, e, s in zip(BWD_COLUMNS, err, scale))
    return max(err[:10]), report


def nbytes(*xs):
    import torch

    return sum(x.numel() * x.element_size() for x in xs if torch.is_tensor(x))


def bound(flops, n_bytes):
    """(ms, what sets it): the least time the card could take for ``flops``
    FP32 operations that move ``n_bytes``."""
    t_ops, t_bytes = flops / PEAK_FP32, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def live_work(feat, lists, counts, done, origins):
    """What a launch's data needs, from its rows (11 or 6 columns), lists,
    counts and ``done``: ``pairs``, the live (pixel, entry) pairs 256 x
    sum_t min(count_t, chunk x done_t) that a walk trimmed at the count
    computes; ``nonzero``, those with a non-zero alpha; ``positions``, the
    list entries they read; ``rows``, the distinct feature rows those
    entries name (the sentinel left out); ``chunks``, sum_t done_t;
    ``tiles``, the tiles with a live position."""
    import torch
    from rtgslam_torch.ops.rasterize import blend

    T, Kt = lists.shape
    chunk = min(blend.CHUNK, Kt)
    V = feat.shape[0] - 1
    n = torch.minimum(counts.long().clamp(0, Kt), chunk * done.long())
    live = torch.arange(Kt, device=lists.device)[None] < n[:, None]
    entries = lists[live]
    pix = blend.tile_pixels(origins)
    nonzero = 0
    for c in range(int(done.max()) if T else 0):
        cols = slice(c * chunk, (c + 1) * chunk)
        for a in torch.nonzero(done > c).squeeze(1).split(256):
            alpha = blend._chunk_alphas(feat[lists[a, cols].long()], pix[a])[0]
            nonzero += int(((alpha != 0) & live[a, None, cols]).sum())
    return {"pairs": blend.NPIX * int(n.sum()), "nonzero": nonzero,
            "positions": int(n.sum()),
            "rows": int(torch.unique(entries[(entries >= 0) & (entries < V)]).numel()),
            "chunks": int(done.long().sum()), "tiles": int((n > 0).sum())}


def work_bound(kind, w, T, n_chunks):
    """(ms, what sets it) of a launch of ``kind`` ("inference", "residual",
    "transmission" or "bwd") on ``T`` tiles of ``n_chunks`` chunks, from
    :func:`live_work`'s counts ``w``.  Bytes: each named row (with its
    index-map value) and live list entry read once, the per-tile and
    per-pixel inputs, every output written once."""
    npix, rows, pos = 256, w["rows"], w["positions"]
    if kind == "transmission":   # 6-column rows in, T out
        return bound(w["pairs"] * ALPHA_OPS + w["nonzero"] * K1_TRANS_OPS,
                     24 * rows + 4 * pos + 12 * T + 4 * npix * T)
    read = 48 * rows + 4 * pos + 12 * T      # rows, lists, counts, origins
    if kind == "bwd":
        # done; the processed chunks' entry T and chunk colours; the live
        # tiles' cotangents, T_final x g_T and depth hits; 10 partials out
        # per position
        return bound(w["pairs"] * ALPHA_OPS + w["nonzero"] * K2_TERM_OPS,
                     read + 4 * T + 16 * npix * w["chunks"]
                     + 24 * npix * w["tiles"] + 40 * pos)
    out = 36 * npix * T   # colour, depth, T, index maps and weights
    if kind == "residual":   # entry T of every chunk, done, chunk colours
        out += 4 * npix * T * n_chunks + 4 * T + 12 * npix * w["chunks"]
    return bound(w["pairs"] * ALPHA_OPS + w["nonzero"] * K1_BLEND_OPS,
                 read + out)


def work_line(name, w):
    return (f"{name} {w['ms']:.4f} ms (plain {w['plain_ms']:.4f}), live pairs "
            f"{w['pairs']}, bound {w['bound_ms']:.4f} ms by {w['bound_by']}, "
            f"share {w['bound_ms'] / w['ms']:.3f}")


def check_inference(label, bargs, smi):
    """K1's inference mode on ``bargs`` against its twin, timed, with its
    live pairs (``done`` from one residual-mode launch on the same inputs)
    and bound."""
    import torch
    from rtgslam_torch.ops.rasterize import blend

    out = blend.blend_tiles(*bargs)
    ref = blend.blend_tiles_reference(*bargs)
    done = blend.blend_tiles(*bargs, residuals=True)[2]
    torch.cuda.synchronize()
    err, ct, dt = compare_blend(out, ref, bargs[0], bargs[1], bargs[4], bargs[5])
    lw = live_work(bargs[0], bargs[2], bargs[3], done, bargs[4])
    T, Kt = bargs[2].shape
    b_ms, by = work_bound("inference", lw, T, Kt // min(blend.CHUNK, Kt))
    w = {"err": err, "pairs": lw["pairs"], "bound_ms": b_ms, "bound_by": by,
         "ms": cuda_ms(lambda: blend.blend_tiles(*bargs), 50),
         "plain_ms": cuda_ms(lambda: blend.blend_tiles_reference(*bargs), 5)}
    print(f"[{label}] lists {tuple(bargs[2].shape)}: max abs err {err:.3g}, "
          f"index near-ties color {ct} depth {dt}; {work_line('K1', w)} ({smi})")
    return w


def check_transmission(label, targs, smi):
    """K1's transmission mode on ``targs`` against its twin, timed, with
    its live pairs (``done`` from a residual-mode launch on the same rows
    widened to 11 columns: the same alphas, the same exit) and bound."""
    import torch
    from rtgslam_torch.ops.rasterize import blend

    cols6, lists, counts, origins, t_thr = targs
    err = compare_transmission(blend.blend_transmission(*targs),
                               blend.blend_transmission_reference(*targs))
    feat = cols6.new_zeros((cols6.shape[0], blend.NFEAT))
    feat[:, [0, 1, 2, 3, 4, 9]] = cols6
    order = torch.arange(cols6.shape[0] - 1, dtype=torch.int32,
                         device=cols6.device)
    done = blend.blend_tiles(feat, order, lists, counts, origins, 1.0, t_thr,
                             residuals=True)[2]
    lw = live_work(cols6, lists, counts, done, origins)
    b_ms, by = work_bound("transmission", lw, lists.shape[0], None)
    w = {"err": err, "pairs": lw["pairs"], "bound_ms": b_ms, "bound_by": by,
         "ms": cuda_ms(lambda: blend.blend_transmission(*targs), 50),
         "plain_ms": cuda_ms(lambda: blend.blend_transmission_reference(*targs), 5)}
    print(f"[{label}] transmission mode, lists {tuple(lists.shape)}: max abs "
          f"err {err:.3g}, mask T != 1 equal; {work_line('K1', w)} ({smi})")
    return w


def check_launch(label, fargs, bargs, smi):
    """K1's residual mode on ``fargs`` and K2 with the reduce on ``bargs``
    (a K1 residual and a K2 launch the main path made, with the run's own
    residuals and cotangents) against their twins; K2 with the reduce twice,
    bitwise equal; each timed, with its live work and bound.  Returns
    {"res", "bwd", "reduce"} -> err, ms, plain_ms, pairs, bound_ms,
    bound_by, library_ms."""
    import torch
    from rtgslam_torch.ops.rasterize import blend

    out, *res = blend.blend_tiles(*fargs, residuals=True)
    ref, *ref_res = blend.blend_tiles_reference(*fargs, residuals=True)
    torch.cuda.synchronize()
    e1, _, _ = compare_blend(out, ref, fargs[0], fargs[1], fargs[4], fargs[5])
    e2, n_edge = compare_residuals(res, ref_res, fargs[6])

    kargs = bargs[:13]
    feat, lists, counts, origins, done = (kargs[i] for i in (0, 2, 3, 4, 6))
    T, Kt = lists.shape
    V = feat.shape[0] - 1
    index = bargs[13] if len(bargs) > 13 and bargs[13] is not None else \
        blend.row_index(lists, counts, V)
    g = blend.blend_bwd(*kargs, index)
    if not torch.equal(g, blend.blend_bwd(*kargs, index)):
        fail(f"{label}: two launches of K2 and the reduce on the same inputs differ")
    e3, cols = compare_bwd(g, blend.blend_bwd_reference(*kargs, index), label)
    partials = blend.blend_bwd_partials(*kargs)
    red = blend.blend_bwd_reduce(partials, index, done)
    red_ref = blend.blend_bwd_reduce_reference(partials, index, done)
    torch.cuda.synchronize()
    e4 = float((red - red_ref).abs().max())
    if not e4 <= REDUCE_ATOL:
        fail(f"{label}: the reduce differs from its twin by {e4:.3g}")
    if not torch.equal(red, g):
        fail(f"{label}: K2's partials differ between launches")

    # the library call that computes the reduce's function: index_add_ of
    # the live positions' partials (positions in CSR order, as the reduce)
    nnz = int(index.row_ptr[V])
    q = index.pos[:nnz].long()
    chunk = min(blend.CHUNK, Kt)
    q = q[(q % Kt) // chunk < done.long()[q // Kt]]
    src, dst = partials.reshape(-1, blend.NGRAD)[q], lists.reshape(-1)[q].long()
    acc = torch.zeros((V + 1, blend.NGRAD), device=feat.device)

    lw_f = live_work(fargs[0], fargs[2], fargs[3], res[1], fargs[4])
    lw = live_work(feat, lists, counts, done, origins)
    live_pos = lw["positions"]
    n_chunks = Kt // chunk
    works = {}
    for name, (b_ms, by), fn, plain, library in (
            ("res", work_bound("residual", lw_f, T, n_chunks),
             lambda: blend.blend_tiles(*fargs, residuals=True),
             lambda: blend.blend_tiles_reference(*fargs, residuals=True), None),
            ("bwd", work_bound("bwd", lw, T, n_chunks),
             lambda: blend.blend_bwd_partials(*kargs),
             lambda: blend.blend_bwd_partials_reference(*kargs), None),
            # the live partials and their positions in the index in, every
            # row out
            ("reduce", bound(blend.NGRAD * live_pos,
                             4 * blend.NGRAD * live_pos
                             + nbytes(index.row_ptr, done) + 4 * nnz
                             + 4 * blend.NFEAT * (V + 1)),
             lambda: blend.blend_bwd_reduce(partials, index, done),
             lambda: blend.blend_bwd_reduce_reference(partials, index, done),
             lambda: acc.index_add_(0, dst, src))):
        works[name] = {"pairs": lw["pairs"] if name != "res" else lw_f["pairs"],
                       "bound_ms": b_ms, "bound_by": by,
                       "ms": cuda_ms(fn, 50), "plain_ms": cuda_ms(plain, 5),
                       "library_ms": cuda_ms(library, 50) if library else None}
    works["reduce"]["pairs"] = None   # it walks list positions, not pairs
    works["res"]["err"], works["bwd"]["err"] = max(e1, e2), e3
    works["reduce"]["err"] = e4
    # the row index: once per compact optimize call, once per backward of
    # the final pass's full renders, whose lists change every iteration
    works["reduce"]["index_ms"] = cuda_ms(
        lambda: blend.row_index(lists, counts, V), 50)

    r = works["reduce"]
    print(f"[{label}] {V} rows ({lw['rows']} named by live entries), lists "
          f"{tuple(lists.shape)}, tiles walking 1/2/3/4+ chunks "
          f"{[int((done == c).sum()) for c in (1, 2, 3)]}/"
          f"{int((done >= 4).sum())}, {lw['nonzero']} of the pairs with a "
          f"non-zero alpha: residual mode max abs err {max(e1, e2):.3g} "
          f"(done threshold ties {n_edge}), {work_line('K1', works['res'])}; "
          f"K2 max abs err {e3:.3g}, per column err/largest: {cols}; "
          f"{work_line('K2', works['bwd'])}; reduce err {e4:.3g} (bitwise), "
          f"{live_pos} live positions, {r['ms']:.4f} ms (plain "
          f"{r['plain_ms']:.4f}, index_add_ {r['library_ms']:.4f}), bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']}; row index "
          f"{r['index_ms']:.4f} ms; K2 with the reduce bitwise equal over two "
          f"launches ({smi})")
    return works


def check_slice(res, label):
    ev = res["eval"]
    vals = [res["ate_cm"], ev["psnr"], ev["depth_l1_cm"]]
    if not all(math.isfinite(v) for v in vals):
        fail(f"{label}: non-finite metrics {vals}")
    if res["max_overflow"] != 0:
        fail(f"{label}: bin overflow {res['max_overflow']}")
    opt = set(res["optimize_frames"]) if res["mapper"].gaussian_update_iter else set()
    track = sorted(res["track_ms"][1:])[len(res["track_ms"][1:]) // 2]
    plain = sorted(m for i, m in enumerate(res["map_ms"]) if i > 0 and i not in opt)
    mapping = plain[len(plain) // 2]
    last = len(res["track_ms"]) - 1
    print(f"[{label}] ATE {res['ate_cm']:.6f} cm  PSNR {ev['psnr']:.6f}  "
          f"depth L1 {ev['depth_l1_cm']:.6f} cm  gaussians "
          f"{res['n_stable'] + res['n_unstable']}  overflow "
          f"{res['max_overflow']}  median tracking {track:.2f} ms (frames "
          f"1..{last}), median mapping {mapping:.2f} ms (frames 1..{last} "
          f"without a gradient pass)")
    if opt:
        each = ", ".join(f"frame {i} {res['map_ms'][i]:.1f}" for i in sorted(opt))
        print(f"[{label}] mapping ms of the gradient-pass frames: {each}; "
              f"final pass {res['final_ms']:.1f} ms over "
              f"{len(res['mapper'].keyframe_list)} keyframes")
    return track, mapping


def check_reference(res, ref_path, tol, label):
    with open(ref_path) as f:
        jref = json.load(f)
    got = {"ate_cm": res["ate_cm"], "psnr": res["eval"]["psnr"],
           "depth_l1_cm": res["eval"]["depth_l1_cm"]}
    for k, v in got.items():
        if not abs(v - jref[k]) <= tol[k]:
            fail(f"{label}: {k} {v:.4f} vs JAX {jref[k]:.4f} (tol {tol[k]})")
    for i, ((u, s), (ru, rs)) in enumerate(zip(res["counts"], jref["counts"])):
        if not abs((u + s) - (ru + rs)) <= tol["gaussians_rel"] * (ru + rs):
            fail(f"{label}: frame {i} holds {u + s} gaussians vs JAX {ru + rs}")
    if res["max_overflow"] != jref["max_overflow"]:
        fail(f"{label}: overflow {res['max_overflow']} vs JAX {jref['max_overflow']}")
    print(f"[{label}] matches the JAX-CPU reference {os.path.basename(ref_path)}: "
          f"ATE {jref['ate_cm']:.4f}, PSNR {jref['psnr']:.3f}, depth L1 "
          f"{jref['depth_l1_cm']:.4f}, gaussians "
          f"{jref['n_stable'] + jref['n_unstable']}, overflow "
          f"{jref['max_overflow']} (tolerances {tol})")


def capture_optimize_launches(blend, optimize, first=()):
    """Patch the optimize calls and the two blend wrappers that
    ``BlendFunction`` reaches, for one run of the main path.  Per kind of
    call ("local" or "global" compact calls, "final" for the final pass's
    full renders) the latest call (the first, for the kinds in ``first``)
    keeps the inputs of its first K1 residual launch ("fwd") and its first
    K2 launch ("bwd"), detached, not copied; every call's (kind,
    iterations, wall seconds between synchronizes) is listed.  Returns
    (captured, calls, restore)."""
    import torch

    captured, calls, kind = {}, [], [None]
    orig = (optimize.optimize_execute, optimize.optimize_chain,
            blend.blend_tiles, blend.blend_bwd)

    def timed(fn, final):
        sig = inspect.signature(fn)

        def call(*a, **k):
            bound = sig.bind(*a, **k).arguments
            name = "final" if final else bound["mode"]
            # kind[0] names the call whose launches are kept, if any
            kind[0] = None if name in first and name in captured else name
            if kind[0]:
                captured[name] = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            calls.append((name, bound["n_iters"], time.perf_counter() - t0))
            kind[0] = None
            return out
        return call

    def keep(key, fn):
        def call(*a, **k):
            if (kind[0] and key not in captured[kind[0]]
                    and (key == "bwd" or k.get("residuals"))):
                captured[kind[0]][key] = tuple(
                    x.detach() if torch.is_tensor(x) else x for x in a)
            return fn(*a, **k)
        return call

    optimize.optimize_execute = timed(orig[0], final=False)
    optimize.optimize_chain = timed(orig[1], final=True)
    blend.blend_tiles = keep("fwd", orig[2])
    blend.blend_bwd = keep("bwd", orig[3])

    def restore():
        (optimize.optimize_execute, optimize.optimize_chain,
         blend.blend_tiles, blend.blend_bwd) = orig
    return captured, calls, restore


def run_entry_points(cfg, priority_source=None):
    """slam_torch.py then metric_torch.py on ``cfg``, from the repository
    root (a config's relative ``parent:`` resolves from the working
    directory), on the default device, CUDA."""
    import metric_torch
    import slam_torch

    os.chdir(REPO)
    res = slam_torch.main(["--config", cfg], priority_source=priority_source)
    met = metric_torch.main(["--config", cfg])
    return res, met


def check_entry(got, ref, tol, label):
    """An entry-point run's summary (tests/torch_parity.py::summarize_run)
    against the JAX reference's."""
    import torch_parity

    for k, t in (("ate_cm", "ate_cm"), ("psnr", "final_psnr"),
                 ("depth_l1_cm", "depth_l1_cm")):
        if not abs(got[k] - ref[k]) <= tol[t]:
            fail(f"{label}: {k} {got[k]:.4f} vs JAX {ref[k]:.4f} (tol {tol[t]})")
    for k in ("save_model_files", "save_traj_files", "csv_columns", "csv_rows",
              "final_eval_file"):
        if got[k] != ref[k]:
            fail(f"{label}: {k} {got[k]} vs JAX {ref[k]}")
    for name, g, r in torch_parity.rows_within(
            got["checkpoint_rows"], ref["checkpoint_rows"], tol["gaussians_rel"]):
        fail(f"{label}: {name} holds {g} rows vs JAX {r} (tolerance "
             f"{tol['gaussians_rel']} of the map's gaussians at that checkpoint)")
    for k in ("psnr", "depth_l1_cm"):
        g, r = got["csv_mean"][k], ref["csv_mean"][k]
        if not abs(g - r) <= tol[k]:
            fail(f"{label}: metric CSV mean {k} {g:.4f} vs JAX {r:.4f}")
    print(f"[{label}] matches the JAX-CPU reference: ATE {got['ate_cm']:.4f} vs "
          f"{ref['ate_cm']:.4f} cm, PSNR {got['psnr']:.3f} vs {ref['psnr']:.3f}, "
          f"depth L1 {got['depth_l1_cm']:.4f} vs {ref['depth_l1_cm']:.4f} cm, "
          f"final gaussians {max(got['checkpoint_rows'].values())} vs "
          f"{max(ref['checkpoint_rows'].values())}, metric CSV mean PSNR "
          f"{got['csv_mean']['psnr']:.3f} vs {ref['csv_mean']['psnr']:.3f}; "
          f"{len(got['save_model_files'])} checkpoint and "
          f"{len(got['save_traj_files'])} trajectory files as JAX's (tolerances {tol})")


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_6a(work):
    """slam_torch.py + metric_torch.py on the room written to disk at 170x300
    against the JAX package's slam.py + metric.py on the CPU."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_parity
    from rtgslam_torch.data.synthetic import write_scene
    from rtgslam_torch.utils import threefry

    t0 = time.perf_counter()
    with open(REF_ENTRY_170) as f:
        eref = json.load(f)
    scene = write_scene(os.path.join(work, "scene170"), eref["frames"],
                        eref["height"], eref["width"])
    cfg = torch_parity.write_child_config(
        os.path.join(work, "entry170.yaml"), torch_parity.ROOM_YAML, scene,
        os.path.join(work, "out170"), eref["overrides"])
    res, _ = run_entry_points(cfg, threefry.jax_priorities())
    got = torch_parity.summarize_run(os.path.join(work, "out170"))
    if res["mapper"].max_overflow != eref["max_overflow"]:
        fail(f"phase 6a: overflow {res['mapper'].max_overflow} vs JAX "
             f"{eref['max_overflow']}")
    check_entry(got, eref, ENTRY_REF_TOL, "phase 6a")
    print(f"[phase 6a] {time.perf_counter() - t0:.1f} s")


def phase_6b(work, cams, dev, smi):
    """slam_torch.py + metric_torch.py on ``cams`` written to disk, the
    reloaded final checkpoint, and K1's residual mode, K2 and the reduce
    against their twins on the first windowed global call's launches.
    Returns the launch counts of the run and :func:`check_launch`'s
    result."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_parity
    from metric_torch import pick_model
    from rtgslam_torch.config import DatasetParams, read_config
    from rtgslam_torch.data.camera import load_camera
    from rtgslam_torch.data.dataset import Dataset
    from rtgslam_torch.data.synthetic import (default_intrinsics, write_frame,
                                              write_intrinsics)
    from rtgslam_torch.models import optimize
    from rtgslam_torch.ops.rasterize import blend
    from rtgslam_torch.slam.eval import eval_frame
    from rtgslam_torch.slam.mapper import Mapper

    t0 = time.perf_counter()
    H, W = cams[0].image_height, cams[0].image_width
    scene = os.path.join(work, "scene_full")
    write_intrinsics(scene, default_intrinsics(H, W))
    for cam in cams:
        write_frame(scene, cam.uid, cam.image, cam.depth, cam.pose_gt)
    save = os.path.join(work, "out_full")
    cfg = torch_parity.write_child_config(
        os.path.join(work, "entry_full.yaml"), ROOM_FULL_YAML, scene, save,
        FULL_OVERRIDES)
    print(f"[phase 6b] wrote the {H}x{W} scene in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    captured6, calls6, restore = capture_optimize_launches(
        blend, optimize, first=("global",))
    blend.reset_launches()
    try:
        res6, met6 = run_entry_points(cfg)
    finally:
        launches6 = dict(blend.launches)
        restore()
    run_s = time.perf_counter() - t0
    mapper6 = res6["mapper"]
    ev6 = res6["final_eval"]
    if mapper6.max_overflow != 0 or ev6["bin_overflow"] != 0:
        fail(f"phase 6b: bin overflow {mapper6.max_overflow}")
    if not res6["ate_cm"] <= BENCH_ATE_CM:
        fail(f"phase 6b: ATE {res6['ate_cm']:.4f} cm > {BENCH_ATE_CM} cm")
    if not ev6["psnr"] >= BENCH_PSNR:
        fail(f"phase 6b: PSNR {ev6['psnr']:.3f} < {BENCH_PSNR}")
    n_global = sum(1 for k, _, _ in calls6 if k == "global")
    if n_global < 1 or set(captured6.get("global", {})) != {"fwd", "bwd"}:
        fail(f"phase 6b: no windowed global optimize call (calls {calls6})")
    iters6 = sum(n for _, n, _ in calls6)
    for name, need in (("blend_fwd", 1), ("blend_fwd_residual", iters6),
                       ("blend_fwd_transmission", 1), ("blend_bwd", iters6),
                       ("blend_bwd_reduce", iters6)):
        if launches6[name] < need:
            fail(f"phase 6b: {name} launched {launches6[name]} times, needs {need}")
    with open(met6["csv"], newline="") as f:
        csv_frames = [r["frame"] for r in csv.DictReader(f)]
    if csv_frames != [str(i) for i in range(len(cams))] + ["mean"]:
        fail(f"phase 6b: {met6['csv']} rows are frames {csv_frames}, not "
             f"0..{len(cams) - 1} and the mean")
    print(f"[phase 6b] {H}x{W} entry points: ATE {res6['ate_cm']:.4f} cm, "
          f"final keyframe {res6['final_eval_uid']} PSNR {ev6['psnr']:.3f} "
          f"depth L1 {ev6['depth_l1_cm']:.4f} cm, gaussians "
          f"{mapper6.get_stable_num}, overflow 0; optimize calls "
          f"{[(k, n) for k, n, _ in calls6]}; launches {launches6} for "
          f"{iters6} iterations; metric CSV mean PSNR "
          f"{met6['mean']['psnr']:.3f}; run {run_s:.1f} s")

    # the final checkpoint in a fresh mapper: the last keyframe at the
    # in-run eval's opaque threshold
    ply, _, _ = pick_model(save, -1, "merge")
    args6 = read_config(cfg)
    fresh = Mapper(args6, dev)
    fresh.load_model(ply)
    dparams = DatasetParams().extract(args6)
    infos = Dataset(dparams).scene_info.train_cameras
    kf = mapper6.keyframe_list[-1]["frame"]
    frame = load_camera(dparams, kf.uid, infos[kf.uid])
    frame.update(kf.R, kf.T)
    fresh._ensure_settings(frame)
    reload_ev = eval_frame(fresh, frame)
    gap = abs(reload_ev["psnr"] - ev6["psnr"])
    if not gap <= RELOAD_PSNR_DB:
        fail(f"phase 6b: {os.path.basename(ply)} reloaded renders PSNR "
             f"{reload_ev['psnr']:.4f} vs {ev6['psnr']:.4f} in the run")
    print(f"[phase 6b] {os.path.basename(os.path.dirname(ply))}/"
          f"{os.path.basename(ply)} ({fresh.get_stable_num} rows) reloaded: "
          f"PSNR {reload_ev['psnr']:.4f} vs {ev6['psnr']:.4f} in the run "
          f"(gap {gap:.2g} dB, bound {RELOAD_PSNR_DB})")

    with open(os.path.join(save, "performance.json")) as f:
        perf = json.load(f)["samples"]
    gl = [(n, s_) for k, n, s_ in calls6 if k == "global"]
    print(f"[phase 6b] median tracking {median(perf['tracking'][1:]) * 1e3:.2f} ms, "
          f"median mapping {median(perf['mapping'][1:]) * 1e3:.2f} ms (frames "
          f"1..{len(cams) - 1}, performance.json); windowed global call "
          f"{gl[0][1] * 1e3 / gl[0][0]:.2f} ms per iteration ({gl[0][0]} "
          f"iterations, setup included); loader decode "
          f"{median(res6['decode_ms'].values()):.2f} ms per frame (median); "
          f"metric_torch {median(met6['frame_ms']):.2f} ms per frame "
          f"(median) ({smi})")

    # K1's residual mode, K2 and the reduce on the first windowed global
    # call's launches
    works = check_launch("phase 6b global", captured6["global"]["fwd"],
                         captured6["global"]["bwd"], smi)
    return launches6, works


def require_launches(label, launches, kernels=KERNELS, need=1):
    for name in kernels:
        if launches[name] < need:
            fail(f"{label}: {name} launched {launches[name]} times, needs {need}")


def counted(fn):
    """(fn's result, the launch counts of fn alone)."""
    from rtgslam_torch.ops.rasterize import blend

    blend.reset_launches()
    out = fn()
    return out, dict(blend.launches)


def add_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in KERNELS}


def time_methods(targets):
    """Patch each ``(owner, name)`` method with a host-clock timer (every
    method here ends in a device-to-host fetch or is host code).  Returns
    ({name: [seconds per call]}, restore)."""
    spent, saved = {}, []
    for owner, name in targets:
        fn = getattr(owner, name)
        saved.append((owner, name, fn))
        spent[name] = []

        def timed(*a, _fn=fn, _s=spent[name], **k):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **k)
            finally:
                _s.append(time.perf_counter() - t0)
        setattr(owner, name, timed)

    def restore():
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return spent, restore


def loop_sequence(cams):
    """Out and back: the tail returns through the earlier viewpoints
    (tests/test_loop_closure.py::_loop_sequence), at TUM's depth factor."""
    out = []
    for i, cam in enumerate(list(cams) + list(cams[-2::-1])):
        c = copy.copy(cam)
        c.uid, c.timestamp, c.depth_scale = i, i / 30.0, TUM_DEPTH_SCALE
        out.append(c)
    return out


def phase_7a(work, dev, smi):
    """The TUM operating point: the entry points at 170x300 against the
    JAX reference, then the 480x640 out-and-back run.  Returns (launch
    counts, check_launch's result on the run's local optimize launch)."""
    import torch_parity
    from rtgslam_torch.data.synthetic import make_cameras
    from rtgslam_torch.models import optimize
    from rtgslam_torch.ops.icp import IcpTracker
    from rtgslam_torch.ops.rasterize import blend
    from rtgslam_torch.slam.loop_closure import LoopCloser
    from rtgslam_torch.slam.run import make_args, run_sequence
    from rtgslam_torch.slam.tracker import Tracker
    from rtgslam_torch.utils import threefry

    t0 = time.perf_counter()
    with open(REF_ORB_170) as f:
        oref = json.load(f)
    save = os.path.join(work, "out_orb170")
    cfg = torch_parity.write_child_config(
        os.path.join(work, "orb170.yaml"), torch_parity.ROOM_YAML,
        os.path.join(work, "scene170"), save, oref["overrides"])
    (res, _), la = counted(lambda: run_entry_points(cfg, threefry.jax_priorities()))
    require_launches("phase 7a 170x300", la)
    if res["mapper"].max_overflow != oref["max_overflow"]:
        fail(f"phase 7a: overflow {res['mapper'].max_overflow}")
    check_entry(torch_parity.summarize_run(save), oref, ORB_REF_TOL,
                "phase 7a 170x300")
    print(f"[phase 7a] 170x300: tracker {dict(res['tracker'].status)}, "
          f"launches {la}; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cams = loop_sequence(make_cameras(LOOP_OUT, TUM_H, TUM_W))
    print(f"[phase 7a] {len(cams)} cameras at {TUM_H}x{TUM_W} in "
          f"{time.perf_counter() - t0:.1f} s")
    args = make_args(TUM_H, TUM_W)
    for k, v in dict(torch_parity.TUM_KEYS, **LOOP_KEYS).items():
        setattr(args, k, v)
    spent, untime = time_methods([(IcpTracker, "predict_pose"),
                                  (Tracker, "_refine_with_backend"),
                                  (LoopCloser, "observe")])
    captured, calls, restore = capture_optimize_launches(blend, optimize)
    t0 = time.perf_counter()
    try:
        res, lb = counted(lambda: run_sequence(args, cams, dev))
    finally:
        restore()
        untime()
    run_s = time.perf_counter() - t0
    status = dict(res["tracker"].status)
    ev = res["eval"]
    if res["max_overflow"] != 0:
        fail(f"phase 7a: bin overflow {res['max_overflow']} at {TUM_H}x{TUM_W}")
    if not res["ate_cm"] <= BENCH_ATE_CM:
        fail(f"phase 7a: ATE {res['ate_cm']:.4f} cm > {BENCH_ATE_CM} cm")
    if not ev["psnr"] >= BENCH_PSNR:
        fail(f"phase 7a: PSNR {ev['psnr']:.3f} < {BENCH_PSNR}")
    if status.get("loops_closed", 0) < 1:
        fail(f"phase 7a: no loop closed (tracker {status})")
    iters = sum(n for _, n, _ in calls)
    require_launches(f"phase 7a {TUM_H}x{TUM_W}", lb)
    require_launches(f"phase 7a {TUM_H}x{TUM_W}", lb, KERNELS[1:2] + KERNELS[3:],
                     iters)
    track, mapping = check_slice(res, f"phase 7a {TUM_H}x{TUM_W}")
    split = {k: median(v) * 1e3 for k, v in spent.items()}
    print(f"[phase 7a] {TUM_H}x{TUM_W}, {len(cams)} frames: tracker {status}; "
          f"median tracking {track:.2f} ms = ICP solve {split['predict_pose']:.2f}"
          f" + backend {split['_refine_with_backend']:.2f} + loop check "
          f"{split['observe']:.2f} (slowest {max(spent['observe']) * 1e3:.2f}) "
          f"+ the rest; median mapping {mapping:.2f} ms; launches {lb} for "
          f"{iters} gradient iterations; run {run_s:.1f} s ({smi})")
    if set(captured.get("local", {})) != {"fwd", "bwd"}:
        fail("phase 7a made no local optimize launch of K1 and K2")
    works = check_launch(f"phase 7a {TUM_H}x{TUM_W} local optimize launch",
                         captured["local"]["fwd"], captured["local"]["bwd"], smi)
    return add_counts(la, lb), works


def phase_7b(work, dev, smi):
    """slam_mp_torch.py at 170x300 (strict every frame, twice, against the
    JAX reference) and at 680x1200 on phase 6b's scene (strict / 5, free).
    Returns the launch counts of the five runs."""
    import metric_torch
    import slam_mp_torch
    import torch_parity
    from rtgslam_torch.config import DatasetParams, read_config
    from rtgslam_torch.data.camera import load_camera
    from rtgslam_torch.data.dataset import Dataset
    from rtgslam_torch.slam.eval import eval_frame
    from rtgslam_torch.utils import threefry

    os.chdir(REPO)
    with open(REF_MP_170) as f:
        mref = json.load(f)
    counts, summaries = [], []
    for rep in range(2):
        t0 = time.perf_counter()
        save = os.path.join(work, f"out_mp170_{rep}")
        cfg = torch_parity.write_child_config(
            os.path.join(work, f"mp170_{rep}.yaml"), torch_parity.ROOM_YAML,
            os.path.join(work, "scene170"), save, mref["overrides"])
        res, lc = counted(lambda: slam_mp_torch.main(
            ["--config", cfg], priority_source=threefry.jax_priorities()))
        require_launches(f"phase 7b 170x300 run {rep}", lc)
        if res["mapper"].max_overflow != 0:
            fail(f"phase 7b: overflow {res['mapper'].max_overflow}")
        metric_torch.main(["--config", cfg])
        got = torch_parity.summarize_run(save)
        counts.append(lc)
        summaries.append(got)
        print(f"[phase 7b] 170x300 strict/1 run {rep}: ATE {got['ate_cm']:.6f} cm, "
              f"PSNR {got['psnr']:.6f}, depth L1 {got['depth_l1_cm']:.6f} cm; "
              f"{time.perf_counter() - t0:.1f} s")
    a, b = summaries
    for k in ("ate_cm", "psnr", "depth_l1_cm", "checkpoint_rows", "csv_mean"):
        if a[k] != b[k]:
            fail(f"phase 7b: two strict/1 runs differ in {k}: {a[k]} vs {b[k]}")
    check_entry(a, mref, ENTRY_REF_TOL, "phase 7b 170x300 strict/1")

    scene = os.path.join(work, "scene_full")
    with open(os.path.join(work, "out_full", "performance.json")) as f:
        single = json.load(f)["samples"]
    n = len(single["tracking"])
    single_ms = sum(single["tracking"][1:] + single["mapping"][1:]) * 1e3 / (n - 1)
    for sync in ("strict", "free"):
        t0 = time.perf_counter()
        save = os.path.join(work, f"out_mp_full_{sync}")
        cfg = torch_parity.write_child_config(
            os.path.join(work, f"mp_full_{sync}.yaml"), ROOM_FULL_YAML, scene,
            save, dict(FULL_OVERRIDES, sync_tracker2mapper_method=sync))
        res, lc = counted(lambda: slam_mp_torch.main(["--config", cfg]))
        counts.append(lc)
        require_launches(f"phase 7b 680x1200 {sync}", lc)
        mapper = res["mapper"]
        args = read_config(cfg)
        dparams = DatasetParams().extract(args)
        infos = Dataset(dparams).scene_info.train_cameras
        kf = mapper.keyframe_list[-1]["frame"]
        frame = load_camera(dparams, kf.uid, infos[kf.uid])
        frame.update(kf.R, kf.T)
        ev = eval_frame(mapper, frame)
        if mapper.max_overflow != 0 or ev["bin_overflow"] != 0:
            fail(f"phase 7b {sync}: bin overflow {mapper.max_overflow}")
        if not res["ate_cm"] <= BENCH_ATE_CM:
            fail(f"phase 7b {sync}: ATE {res['ate_cm']:.4f} cm > {BENCH_ATE_CM} cm")
        if not ev["psnr"] >= BENCH_PSNR:
            fail(f"phase 7b {sync}: PSNR {ev['psnr']:.3f} < {BENCH_PSNR}")
        dirs = set(os.listdir(os.path.join(save, "save_model")))
        mid = {f"frame_{t:04d}" for t in range(len(infos))
               if (t + 1) % int(args.save_step) == 0 or t == 0}
        if not mid <= dirs:
            fail(f"phase 7b {sync}: mid-run checkpoints {sorted(mid - dirs)} missing")
        samples = res["recorder"].samples
        ends = res["map_end"]
        wall_ms = (ends[max(ends)] - ends[0]) * 1e3 / (len(ends) - 1)
        policy = (sync if sync == "free"
                  else f"{sync}/{args.sync_tracker2mapper_frames}")
        print(f"[phase 7b] 680x1200 {policy}: "
              f"ATE {res['ate_cm']:.4f} cm, keyframe {kf.uid} PSNR "
              f"{ev['psnr']:.3f}, overflow 0, checkpoints {sorted(dirs)}; median "
              f"tracking {median(samples['tracking'][1:]) * 1e3:.2f} ms, "
              f"mapping {median(samples['mapping'][1:]) * 1e3:.2f} ms per frame "
              f"(each thread's clock after its own stream's synchronize); wall "
              f"{wall_ms:.2f} ms per frame (frames 1..{len(ends) - 1}, between "
              f"mapping ends) against phase 6b's single-process tracking + "
              f"mapping {single_ms:.2f} ms per frame; launches {lc}; "
              f"{time.perf_counter() - t0:.1f} s ({smi})")
    return add_counts(*counts)


def phase_7c(mapper, args, smi):
    """One local call with frozen binning (optimize_compact off,
    optimize_freeze_binning on) over phase 5's final map and frame memory.
    The final pass fixed every gaussian, so the map is returned to the
    unstable pool first: the local call's render pool and update pool are
    then the whole map.  Returns (launch counts, check_launch's result)."""
    from rtgslam_torch.config import OptimizationParams
    from rtgslam_torch.models import optimize
    from rtgslam_torch.models.gaussian_map import UNSTABLE, alive_mask
    from rtgslam_torch.ops.rasterize import blend

    t0 = time.perf_counter()
    state = mapper.state
    state.status[alive_mask(state)] = UNSTABLE
    mapper.optimize_compact, mapper.freeze_binning = False, True
    losses, loss_fn = [], optimize._loss_fn

    def recording(*a, **k):
        loss, report = loss_fn(*a, **k)
        losses.append(report["total"].detach())
        return loss, report

    optimize._loss_fn = recording
    captured, calls, restore = capture_optimize_launches(blend, optimize)
    try:
        frame = mapper.processed_frames[-1]["camera"]
        _, lc = counted(lambda: mapper.local_optimize(
            frame, OptimizationParams().extract(args)))
    finally:
        restore()
        optimize._loss_fn = loss_fn
    if len(calls) != 1 or set(captured.get("final", {})) != {"fwd", "bwd"}:
        fail(f"phase 7c: no frozen-binning optimize call (calls {calls})")
    (_, n_iters, s), = calls
    require_launches("phase 7c", lc, KERNELS[1:2] + KERNELS[3:], n_iters)
    require_launches("phase 7c", lc, KERNELS[2:3])
    # iterations past the middle all take the newest frame (mapper.py:605)
    late = n_iters // 2 + 1
    loss = [float(x) for x in losses]
    if len(loss) != n_iters or not all(math.isfinite(x) for x in loss):
        fail(f"phase 7c: losses {loss}")
    print(f"[phase 7c] frozen-binning local call over {mapper.get_unstable_num} "
          f"gaussians and {len(mapper.processed_frames)} frames: {n_iters} "
          f"iterations, {s * 1e3 / n_iters:.2f} ms per iteration (masks and "
          f"the one binning pass included), loss {loss[0]:.6f} at the first "
          f"iteration; on the newest frame {loss[late]:.6f} at iteration "
          f"{late} -> {loss[-1]:.6f} at the last; launches {lc} ({smi})")
    works = check_launch("phase 7c frozen-binning launch",
                         captured["final"]["fwd"], captured["final"]["bwd"], smi)
    print(f"[phase 7c] {time.perf_counter() - t0:.1f} s")
    return lc, works


def main():
    import torch

    # ---- phase 1: the card ---------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from rtgslam_torch import setup_device
    from rtgslam_torch.data.synthetic import make_cameras
    from rtgslam_torch.models import optimize
    from rtgslam_torch.models.gaussian_map import (alive_mask, render_inputs,
                                                   stable_mask)
    from rtgslam_torch.ops.rasterize import api, binning, blend
    from rtgslam_torch.ops.rasterize.project import project_geometry
    from rtgslam_torch.slam.run import make_args, run_sequence
    from rtgslam_torch.utils import cuda_build, threefry

    t_start = time.perf_counter()
    dev = setup_device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build K1 and K2, one nvcc each, started together -------
    t0 = time.perf_counter()
    cuda_build.build("blend_fwd", "blend_bwd")
    for name in ("blend_fwd", "blend_bwd"):
        blend._kernel_lib(name)   # bind the entry points
        info = cuda_build.build_info[name]
        print(f"[phase 2] built {name} in {info['seconds']:.2f} s")
        print(info["ptxas"].strip())
    cuda_build.build_host("pose_backend")
    print(f"[phase 2] built the pose backend (g++) in "
          f"{cuda_build.build_info['pose_backend']['seconds']:.2f} s")
    print(f"[phase 2] {time.perf_counter() - t0:.2f} s")

    # ---- phase 3a: K1 inference vs plain on random tiles ---------------------
    t0 = time.perf_counter()
    feat, order, lists, counts, origins = random_tiles(dev)
    out = blend.blend_tiles(feat, order, lists, counts, origins, 0.6, 1e-4)
    ref = blend.blend_tiles_reference(feat, order, lists, counts, origins, 0.6, 1e-4)
    torch.cuda.synchronize()
    err_rand, ct, dt = compare_blend(out, ref, feat, order, origins, 0.6)
    print(f"[phase 3a] random tiles {tuple(lists.shape)}, counts at the trim "
          f"edges {trim_edges(lists.shape[1])} among them: max abs err "
          f"{err_rand:.3g}, index near-ties color {ct} depth {dt}")

    # ---- phase 3c: K1 residual and transmission modes on random tiles -------
    out, *res = blend.blend_tiles(feat, order, lists, counts, origins, 0.6,
                                  1e-4, residuals=True)
    ref, *ref_res = blend.blend_tiles_reference(
        feat, order, lists, counts, origins, 0.6, 1e-4, residuals=True)
    torch.cuda.synchronize()
    err_res, _, _ = compare_blend(out, ref, feat, order, origins, 0.6)
    e, n_edge = compare_residuals(res, ref_res, 1e-4)
    err_res = max(err_res, e)
    cols6 = feat[:, [0, 1, 2, 3, 4, 9]].contiguous()
    err_trans = compare_transmission(
        blend.blend_transmission(cols6, lists, counts, origins, 1e-4),
        blend.blend_transmission_reference(cols6, lists, counts, origins, 1e-4))
    print(f"[phase 3c] random tiles: residual mode max abs err {err_res:.3g} "
          f"(done differs at {n_edge} threshold ties), transmission mode "
          f"{err_trans:.3g}, mask T != 1 equal")

    # ---- phase 3d: K2 and the reduce vs the plain backward on random tiles --
    gc, gd, gt = random_cotangents(lists.shape[0], dev)
    bargs = (feat, order, lists, counts, origins, *ref_res[:2], ref_res[2],
             gc, gd, ref.T_final * gt, ref.depth_index, 0.6)
    g = blend.blend_bwd(*bargs)
    if not torch.equal(g, blend.blend_bwd(*bargs)):
        fail("phase 3d: two launches of K2 and the reduce differ")
    err_bwd, cols = compare_bwd(g, blend.blend_bwd_reference(*bargs), "phase 3d")
    index = blend.row_index(lists, counts, feat.shape[0] - 1)
    partials = blend.blend_bwd_partials(*bargs)
    err_red = float((blend.blend_bwd_reduce(partials, index, ref_res[1])
                     - blend.blend_bwd_reduce_reference(partials, index,
                                                        ref_res[1])).abs().max())
    if not err_red <= REDUCE_ATOL:
        fail(f"phase 3d: the reduce differs from its twin by {err_red:.3g}")
    print(f"[phase 3d] random tiles: K2 max abs err {err_bwd:.3g}; per column "
          f"err/largest: {cols}; reduce err {err_red:.3g}; bitwise equal over "
          f"two launches; phase 3 {time.perf_counter() - t0:.1f} s")

    # ---- phase 4: forward-only loop at 170x300 vs the JAX reference ----------
    t0 = time.perf_counter()
    cams170 = make_cameras(FRAMES, 170, 300)
    args = make_args(170, 300)
    args.gaussian_update_iter = 0
    args.final_global_iter = 0
    res = run_sequence(args, copy.deepcopy(cams170), dev, threefry.jax_priorities())
    check_slice(res, "phase 4 170x300 forward-only")
    check_reference(res, REF_170, REF_TOL, "phase 4")
    print(f"[phase 4] {time.perf_counter() - t0:.1f} s")

    # ---- phase 4b: the loop with optimization at 170x300 ---------------------
    t0 = time.perf_counter()
    res = run_sequence(make_args(170, 300), copy.deepcopy(cams170), dev,
                       threefry.jax_priorities())
    check_slice(res, "phase 4b 170x300 optimize")
    check_reference(res, REF_OPT_170, OPT_REF_TOL, "phase 4b")
    print(f"[phase 4b] {time.perf_counter() - t0:.1f} s")

    # ---- phase 5: the main path at 680x1200 -------------------------------
    t0 = time.perf_counter()
    args = make_args(680, 1200)
    if args.map_capacity != 1 << 19:
        fail(f"map capacity {args.map_capacity} != 2^19")
    cams = make_cameras(FRAMES, 680, 1200)
    print(f"[phase 5] cameras {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    captured, calls, restore = capture_optimize_launches(blend, optimize)
    blend.reset_launches()
    res = run_sequence(args, copy.deepcopy(cams), dev)
    launches = dict(blend.launches)
    restore()
    run_s = time.perf_counter() - t0
    track_ms, map_ms = check_slice(res, "phase 5 680x1200")
    mapper = res["mapper"]
    renders = 2 * FRAMES   # lifecycle render per frame, spawn render from frame 1, eval
    iters = (args.gaussian_update_iter * len(res["optimize_frames"])
             + args.final_global_iter * len(mapper.keyframe_list))
    for name, need in (("blend_fwd", renders), ("blend_fwd_residual", iters),
                       ("blend_fwd_transmission", 1), ("blend_bwd", iters),
                       ("blend_bwd_reduce", iters)):
        if launches[name] < need:
            fail(f"phase 5: {name} launched {launches[name]} times, needs {need}")
    if not res["ate_cm"] <= BENCH_ATE_CM:
        fail(f"phase 5: ATE {res['ate_cm']:.4f} cm > {BENCH_ATE_CM} cm")
    if not res["eval"]["psnr"] >= BENCH_PSNR:
        fail(f"phase 5: PSNR {res['eval']['psnr']:.3f} < {BENCH_PSNR}")
    per_kind = {}
    for kind, n, _ in calls:
        per_kind[kind] = per_kind.get(kind, 0) + n
    print(f"[phase 5] launches {launches} for {renders} renders and {iters} "
          f"gradient iterations (K1 residual, K2 and reduce launches per call "
          f"kind: {per_kind}); run {run_s:.1f} s")
    for kind in sorted({k for k, _, _ in calls}):
        each = ", ".join(f"{s * 1e3 / n:.2f}" for k, n, s in calls if k == kind)
        print(f"[phase 5] optimize loop, {kind} calls: ms per iteration "
              f"(setup included) {each} ({smi})")

    # ---- phase 3b: K1 inference on the real tile lists of that map ----------
    t0 = time.perf_counter()
    st = mapper.settings
    camera = cams[-1].device_dict(dev)
    gauss = render_inputs(mapper.state, alive_mask(mapper.state))
    feat, bins = api._sorted_pass(gauss, camera["w2c"], camera["K"],
                                  camera["campos"], st)
    origins = binning.tile_origins(st.height, st.width, dev)
    bargs = (feat, bins.order, bins.tile_lists, bins.tile_counts, origins,
             st.opaque_threshold, st.T_threshold)
    inf = check_inference(f"phase 3b 680x1200 frame, {int(bins.n_visible)} "
                          f"visible", bargs, smi)

    # ---- phase 3e: the gradient path's kernels at the main path's shapes ----
    # transmission mode: the stable pool's mask render (global passes)
    stable = render_inputs(mapper.state, stable_mask(mapper.state))
    geo = project_geometry(stable["xyz"], stable["scales"], stable["rotations"],
                           stable["alive"], camera["w2c"], camera["K"],
                           st.width, st.height, st.scale_modifier)
    tb = binning.bin_gaussians(geo, st.height, st.width, st.block_capacity,
                               st.tile_capacity, st.max_visible)
    targs = (api.transmission_rows(geo, tb.order, stable["opacity"]),
             tb.tile_lists, tb.tile_counts, origins, st.T_threshold)
    trans = check_transmission("phase 3e stable pool", targs, smi)

    # residual mode, K2 and the reduce on the launches phase 5 made: the last
    # local call's compact lists and the final pass's full ones, with the
    # run's own cotangents
    works = {}
    for kind in ("local", "final"):
        if set(captured.get(kind, {})) != {"fwd", "bwd"}:
            fail(f"phase 5 made no {kind} optimize launch of K1 and K2")
        works[kind] = check_launch(f"phase 3e {kind} optimize launch",
                                   captured[kind]["fwd"], captured[kind]["bwd"],
                                   smi)
    print(f"[phase 3b/3e] {time.perf_counter() - t0:.1f} s")

    by_phase = {"5": launches}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        phase_6a(work)
        by_phase["6b"], works["global"] = phase_6b(work, cams, dev, smi)
        by_phase["7b"] = phase_7b(work, dev, smi)
        by_phase["7c"], works["frozen"] = phase_7c(mapper, args, smi)
        by_phase["7a"], works["tum"] = phase_7a(work, dev, smi)
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    # the kernels line gives the local calls' shape, where most gradient
    # launches fall; max_abs_err is the largest of every phase; launches
    # are phase 5's, launches_by_phase those of each path's own run
    def err(part):
        return max(w[part]["err"] for w in works.values())

    def entry(name, source, line, w, max_abs_err):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": "rtgslam_tpu/ops/rasterize/pallas_blend.py:" + line,
                "launches": launches[name], "max_abs_err": max_abs_err,
                "ms": w["ms"], "plain_ms": w["plain_ms"],
                "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
                "library_ms": w.get("library_ms"), "live_pairs": w["pairs"],
                "launches_by_phase": {k: c[name] for k, c in by_phase.items()}}

    src = "rtgslam_torch/csrc/"
    loc = works["local"]
    print(json.dumps({"kernels": [
        entry("blend_fwd", "blend_fwd.cu", "60", inf, max(err_rand, inf["err"])),
        entry("blend_fwd_residual", "blend_fwd.cu", "60", loc["res"],
              max(err_res, err("res"))),
        entry("blend_fwd_transmission", "blend_fwd.cu", "60", trans,
              max(err_trans, trans["err"])),
        entry("blend_bwd", "blend_bwd.cu", "180", loc["bwd"],
              max(err_bwd, err("bwd"))),
        entry("blend_bwd_reduce", "blend_bwd.cu", "180", loc["reduce"],
              max(err_red, err("reduce"))),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
