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
  3f. the bilateral depth filter's kernel (csrc/bilateral.cu) against its
      plain loop at 480x640 and 680x1200 on Kinect-noisy depth with holes
      (tests/torch_parity.py::kinect_depth), bitwise; the kernel's time and
      bound, both host times with a synchronize, and in one profile the
      kernel's one launch and the loop's 900 with their summed device time;
  4.  the forward-only loop (both iteration counts 0) at 170x300 x 12
      frames against the JAX-on-CPU reference tests/data/slice_170x300_jax_cpu.json;
  4b. the loop with gradient optimization (bench.make_args unchanged) at
      170x300 x 12 frames against tests/data/slice_opt_170x300_jax_cpu.json;
  4c. the same at 340x600 (configs/synthetic/room_mid.yaml's size) against
      tests/data/slice_opt_340x600_jax_cpu.json, with 4b's tolerances;
  5.  the bench point with optimization at 680x1200 x 12 frames (map
      capacity 2^19) with the launch counts reset just before: overflow 0,
      finite metrics, ATE <= 1 cm, PSNR >= 27.5, K1 launched at least once
      per render and per iteration, K2 and the reduce once per iteration;
      the run keeps the inputs of the first K1 residual and K2 launches of
      its last local optimize call and of its final pass, and times every
      optimize call;
  5r. phase 5's frames again with the JAX mapper's spawn priorities, with
      the launch counts reset just before, against the JAX-on-CPU reference
      tests/data/slice_opt_680x1200_jax_cpu.json at OPT_REF_TOL (ATE, PSNR,
      depth L1, per-frame gaussians, overflow exact); its tracking, mapping
      and gradient-frame times beside phase 5's;
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
      launches, K2 with the reduce twice, bitwise equal (full frames);
  10. the row-band path (slam.py's banded loop) through slam_torch.py,
      after 6b: 10a room_mid.yaml's keys (two 170x600 bands, tracking at
      170x300) on phase 4c's 12 frames written to disk, slam_torch.py +
      metric_torch.py against the JAX package's run on the CPU,
      tests/data/entry_bands_340x600_jax_cpu.json (check_entry at
      ENTRY_REF_TOL; the banded final PSNR at its final_psnr tolerance);
      on 6b's 680x1200 scene, 10b room_full.yaml's own keys (eight 85x1200
      bands, tracking at 170x300): ATE <= 1 cm, banded final PSNR >= 27.5,
      a gradient call, every kernel launched, the first local call's K1
      residual, K2 and reduce launches against their twins, the overflow
      of the band, feedback and final-eval renders reported; 10c the same
      with BAND_FIT_CAPACITIES: overflow 0 in every render; 10a also holds
      the JAX mapper's count of its run (Mapper.lifecycle_overflow, as
      slam.py prints it) to the reference's within LIFECYCLE_OVERFLOW_RTOL;
      10d the undersized 96x128 case of tests/test_torch_overflow.py (tile
      64, block 128, forward-only; whole frames, on a mesh of MESH_SHARDS
      virtual shards, and in two row bands) against
      tests/data/overflow{,_bands2}_96x128_jax_cpu.json: the lifecycle count
      after every frame, pending and folded, and the gaussian counts exact;
  7a. the TUM operating point (configs/tum_base.yaml's tracking and mapping
      keys, tests/torch_parity.py::TUM_KEYS: the staged tracking path through
      the native pose backend, loop detection, the depth filter, a gradient
      pass every 4th frame): slam_torch.py + metric_torch.py on phase 6a's
      room on disk against tests/data/entry_orb_170x300_jax_cpu.json, the
      final keyframe's PSNR inside the range of JAX's own perturbed runs
      (tests/data/entry_orb_170x300_jax_spread.json); then
      at TUM's 480x640, 12 frames out and 11 back with a check every frame:
      ATE <= 1 cm, PSNR >= 27.5, overflow 0, a loop closed, the split of the
      tracking time (ICP, backend, loop check), K1 and K2 on the run's own
      launches against their twins; in both runs the bilateral kernel
      launches once for every filtered frame (at 480x640, every frame);
  7b. slam_mp_torch.py (tracker and mapper threads, each on its own CUDA
      stream): at 170x300 with strict sync every frame, twice (equal ATE,
      PSNR and rows) and against tests/data/mp_170x300_jax_cpu.json; at
      680x1200 on phase 6b's scene cut to its first MP_FULL_FRAMES frames
      with the config's strict / 5 and then free: ATE, PSNR, overflow as in
      6b, mid-run checkpoints, the tracking, mapping and wall time per frame
      against 6b's single-process run over the same frames;
  7c. frozen binning (optimize_compact off, optimize_freeze_binning on): one
      local call over phase 5's final map and frame memory, its first K1
      residual and K2 launches against their twins, the ms per iteration and
      the loss of its first and last iteration.
  8.  bench_torch.py: as a subprocess at its default 170x300 x 40 with one
      rep and RTG_PERF=1 (exit 0, bench.py's JSON keys less its TPU link's,
      the gates PSNR >= 27.5, ATE <= 0.5 cm, overflow 0, the host spans in
      detail.perf); then its reps in process on phase 5's 680x1200 frames
      (warm-up 2, one rep) with the launch counts reset just before: K1 at
      least once per render and per iteration, K2 and the reduce once per
      iteration, the first local call's K1 residual and K2 launches against
      their twins;
  F3. accumulate_gaussian_error on the lifecycle's inputs for phase 5's
      last frame over phase 8's map: two runs on the card bitwise equal,
      the CPU's sums within SEGMENT_RTOL of the largest;
  9.  the multi-device path (rtgslam_torch/parallel/) on a mesh of
      MESH_SHARDS virtual shards of cuda:0, with phase 5's map and frames:
      9a sp_render of the final map from the last camera against render,
      every output bitwise, K1 launched once per shard and one shard's
      launch against its twin; 9b dp_local_optimize and dp_global_optimize
      (sample ratio -1) with the last frame on every shard, DP_STEPS
      iterations, against the one-device optimize_chain on that frame:
      parameters bitwise, the local pass's confidence bitwise, the global
      pass's unchanged; 9c sp_optimize_execute on the inputs of phase 5's
      last local call, SP_ITERS iterations, against optimize_execute on
      them (the JAX test's tolerances, SP_TOL; the line reports whether
      they are bitwise equal, as the sharded blend's one reduce makes
      them); 9d the mapper with mesh= and multi_device on phase 5's
      frames with 6b's keys at MESH_ITERS
      iterations: overflow 0, ATE <= 1 cm, PSNR >= 27.5, a local and a
      windowed global call on the mesh, every kernel launched, the first
      local launch of K1's residual mode and K2 against their twins.
Phases 7b and 7c run before 7a; phase 9 runs after 3b/3e and before 6a;
phase 10 after 6b.
Each of phases 5, 5r, 6b, 7a, 7b, 7c, 8, 9 and 10 resets the launch counts just
before its runs and reads them just after, and fails if a kernel its path
runs was not launched there.
For every launch measured in 3b, 3e, 6b, 7a-7c, 8, 9 and 10 the script prints the live
(pixel, entry) pairs its inputs need and how many of them have a non-zero
alpha, the least time the card could take for that work (the bound: FP32
operations over 67 TFLOP/s or bytes over 3.35 TB/s, whichever is larger;
the operations charged per pair as the data needs them, the bytes of the
rows and list entries the walks read and of the outputs), the kernel's
CUDA-event time and its share of the bound; for K2's launches also the
time of the reduce's row index.
Every printed time stands beside the card's name and power limit.
The line before the last is the kernel report, the last the device line.
"""

import contextlib
import copy
import csv
import functools
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
# JAX's own final keyframe on the TUM keys under rounding-size perturbations
# of its frames (tests/torch_parity.py --orb --spread): phase 7a's must lie
# in [min, max], with no tolerance added
REF_ORB_SPREAD = os.path.join(REPO, "tests", "data",
                              "entry_orb_170x300_jax_spread.json")
REF_MP_170 = os.path.join(REPO, "tests", "data", "mp_170x300_jax_cpu.json")
REF_OPT_340 = os.path.join(REPO, "tests", "data", "slice_opt_340x600_jax_cpu.json")
# phase 5r: the main path at its own operating point, JAX on the CPU
# (tests/torch_parity.py --optimize --frames 12 --height 680 --width 1200)
REF_OPT_680 = os.path.join(REPO, "tests", "data", "slice_opt_680x1200_jax_cpu.json")
# phase 10a: slam.py + metric.py with room_mid.yaml's keys (2 row bands,
# tracking at stride 2) at 340x600 on the CPU
REF_BANDS_340 = os.path.join(REPO, "tests", "data", "entry_bands_340x600_jax_cpu.json")
# phase 8: bench_torch.py's JSON line (bench.py's keys, less those of its
# TPU link, and the JAX mapper's overflow count beside bin_overflow) and its
# spans under RTG_PERF=1
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {
    "H", "W", "frames", "reps", "rep_fps", "rep_median_mapping_ms",
    "mean_tracking_ms", "mean_mapping_ms", "median_tracking_ms",
    "median_mapping_ms", "fps_reference_mean_rule", "fps_median_rule",
    "e2e_fps", "ate_cm", "psnr", "depth_l1_cm", "gaussians", "bin_overflow",
    "lifecycle_overflow", "perf"}
BENCH_SPANS = {"track.frame", "track.upload", "track.dispatch",
               "track.pose_fetch", "map.frame", "map.counter_fetch",
               "map.spawn_chain", "map.frame_chain", "map.local_optimize",
               "map.lifecycle_chain", "optimize.iter"}
BENCH_WARMUP_IN_PROCESS = 2
# the F3 check: the card's per-gaussian error sums against the CPU's (another
# summation order), relative to the largest total
SEGMENT_RTOL = 1e-4
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
# windowed global optimization; whole frames (room_full.yaml's frame_bands
# 8 is phase 10b's)
FULL_OVERRIDES = {"keyframe_trans_thes": 0.003, "keyframe_theta_thes": 0.25,
                  "stable_confidence_thres": 40, "save_step": 6,
                  "frame_bands": 1}
# phase 10c: capacities that fit room_full.yaml's banded density.  Each
# 85x1200 band samples 50,000 of its 102,000 pixels, eight times a whole
# frame's density, and the feedback render at 170x300 bins the whole map
# into tiles of 64x64 frame pixels: with the shipped capacities (max_visible
# 131,072, block 4,096, tile 1,024) both drop entries (10b, as JAX's own
# room_mid.yaml run drops 361 at 340x600).  A capacity changes no render
# while nothing overflows
BAND_FIT_CAPACITIES = {"max_visible": 262144, "block_capacity": 131072,
                       "tile_capacity": 8192}
# the reloaded final checkpoint against the in-run eval of the last keyframe
RELOAD_PSNR_DB = 0.01
FRAMES = 12
# phase 7b's 680x1200 runs: frames 0-5 of the 6b scene (gradient passes on
# 0 and 5), which keeps the whole script near 300 s
MP_FULL_FRAMES = 6
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
# phase 10a: the JAX mapper's overflow count (Mapper.lifecycle_overflow, the
# lifecycle renders only, as slam.py prints it) against the 361 entries
# JAX's own run dropped.  The port's run takes another course (ATE 0.0526
# against 0.0453 cm on the H100), so the renders that drop entries are not
# the same ones; the largest count over frames is held relative to JAX's.
# On the CPU the port's run (tests/torch_parity.py --port --entry --bands 2
# --height 340 --width 600: ATE 0.0488 cm) counted 343, 5.0 % below; the
# card's course differs again, so twice that gap
LIFECYCLE_OVERFLOW_RTOL = 0.1
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
# phase 9: the mesh's virtual shards of cuda:0, the iterations of 9b and 9c,
# and 9d's iterations per optimize call (6b's run)
MESH_SHARDS, DP_STEPS, SP_ITERS, MESH_ITERS = 4, 5, 6, 30
# 9c against the one-device compact loop: tests/test_parallel.py:257-266
# (the shards' gradients are added in another order)
SP_TOL = {"report": (1e-4, 1e-6), "params": (2e-4, 2e-6)}
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


# the bilateral filter's FP32 operations a pixel (csrc/bilateral.cu): 81
# taps of 9 (expf counted as one) and 3 to finish
BILATERAL_OPS = 81 * 9 + 3
# the plain loop's kernels a call on torch 2.11 (copies and memsets left
# out): 81 taps of 11 elementwise ops, the pad, two zeros_like, 4 to finish
PLAIN_FILTER_KERNELS = 900


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


def check_slice(res, label, smi):
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
          f"without a gradient pass) ({smi})")
    if opt:
        each = ", ".join(f"frame {i} {res['map_ms'][i]:.1f}" for i in sorted(opt))
        print(f"[{label}] mapping ms of the gradient-pass frames: {each}; "
              f"final pass {res['final_ms']:.1f} ms over "
              f"{len(res['mapper'].keyframe_list)} keyframes ({smi})")
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


def capture_optimize_launches(blend, optimize, first=(), targets=None):
    """Patch the optimize calls and the two blend wrappers that
    ``BlendFunction`` reaches, for one run of the main path.  Per kind of
    call ("local" or "global" compact calls, "final" for the final pass's
    full renders) the latest call (the first, for the kinds in ``first``)
    keeps the inputs of its first K1 residual launch ("fwd") and its first
    K2 launch ("bwd"), detached, not copied; every call's (kind,
    iterations, wall seconds between synchronizes) is listed.  ``targets``
    replaces the patched calls: (owner, name, bound arguments -> (kind,
    iterations)) each.  Returns (captured, calls, restore)."""
    import torch

    if targets is None:
        targets = ((optimize, "optimize_execute",
                    lambda b: (b["mode"], b["n_iters"])),
                   (optimize, "optimize_chain", lambda b: ("final", b["n_iters"])))
    captured, calls, kind = {}, [], [None]
    orig = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    orig_blend = (blend.blend_tiles, blend.blend_bwd)

    def timed(fn, kind_of):
        sig = inspect.signature(fn)

        def call(*a, **k):
            name, n_iters = kind_of(sig.bind(*a, **k).arguments)
            # kind[0] names the call whose launches are kept, if any
            kind[0] = None if name in first and name in captured else name
            if kind[0]:
                captured[name] = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            calls.append((name, n_iters, time.perf_counter() - t0))
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

    for (owner, name, fn), (_, _, kind_of) in zip(orig, targets):
        setattr(owner, name, timed(fn, kind_of))
    blend.blend_tiles = keep("fwd", orig_blend[0])
    blend.blend_bwd = keep("bwd", orig_blend[1])

    def restore():
        for owner, name, fn in orig:
            setattr(owner, name, fn)
        blend.blend_tiles, blend.blend_bwd = orig_blend
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


def phase_6a(work, smi):
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
    print(f"[phase 6a] {time.perf_counter() - t0:.1f} s ({smi})")


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
    from rtgslam_torch.models import optimize
    from rtgslam_torch.ops.rasterize import blend
    from rtgslam_torch.slam.eval import eval_frame
    from rtgslam_torch.slam.mapper import Mapper

    t0 = time.perf_counter()
    H, W = cams[0].image_height, cams[0].image_width
    scene = write_cams(os.path.join(work, "scene_full"), cams)
    save = os.path.join(work, "out_full")
    cfg = torch_parity.write_child_config(
        os.path.join(work, "entry_full.yaml"), ROOM_FULL_YAML, scene, save,
        FULL_OVERRIDES)
    print(f"[phase 6b] wrote the {H}x{W} scene in {time.perf_counter() - t0:.1f} s ({smi})")
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
          f"{met6['mean']['psnr']:.3f}; run {run_s:.1f} s ({smi})")

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


def write_cams(scene, cams):
    """In-memory frames on disk in the "ours" layout, as ``write_scene``
    writes them (no ray casting again)."""
    from rtgslam_torch.data.synthetic import (default_intrinsics, write_frame,
                                              write_intrinsics)

    write_intrinsics(scene, default_intrinsics(cams[0].image_height,
                                               cams[0].image_width))
    for cam in cams:
        write_frame(scene, cam.uid, cam.image, cam.depth, cam.pose_gt)
    return scene


def banded_run(cfg, metric=True, priority_source=None):
    """The entry points on a banded config, their stdout kept: (slam_torch's
    result, metric_torch's or None, the banded line's numbers)."""
    import metric_torch
    import slam_torch
    import torch_parity

    os.chdir(REPO)
    log = torch_parity.Tee()
    with contextlib.redirect_stdout(log):
        res = slam_torch.main(["--config", cfg], priority_source=priority_source)
    met = metric_torch.main(["--config", cfg]) if metric else None
    return res, met, torch_parity.banded_eval(log.text())


def band_timings(save, res):
    """Per-frame tracking and mapping ms of a run (performance.json) and
    its gradient frames'."""
    with open(os.path.join(save, "performance.json")) as f:
        perf = json.load(f)["samples"]
    grad = sorted(set(res["mapper"].optimize_frames_ids) - {0})
    plain = [m for i, m in enumerate(perf["mapping"]) if i and i not in grad]
    return {"tracking_ms": f"{median(perf['tracking'][1:]) * 1e3:.2f}",
            "mapping_ms": (f"{median(plain) * 1e3:.2f}" if plain
                           else "none (a gradient pass every frame)"),
            "gradient_frames_ms": {i: round(perf["mapping"][i] * 1e3, 1)
                                   for i in grad}}


def track_shape(res):
    """The size the run tracked at: its last tracked depth map's."""
    h, w = res["tracker"]._prev_depth.shape[:2]
    return f"{h}x{w}"


def phase_10(work, cams340, smi):
    """The row-band path (slam.py's banded loop) through the entry points:
    10a room_mid.yaml's keys at 340x600 against the JAX reference; on phase
    6b's 680x1200 scene, 10b room_full.yaml's own keys (ATE, PSNR, the
    first local call's launches against their twins; its overflow
    reported) and 10c the same with BAND_FIT_CAPACITIES (overflow 0 in
    every render); between them 10d (:func:`phase_10d`).  Returns (the
    launch counts of its runs, check_launch's result)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_parity
    from rtgslam_torch.config import read_config
    from rtgslam_torch.models import optimize
    from rtgslam_torch.ops.rasterize import blend
    from rtgslam_torch.utils import threefry

    # ---- 10a: 340x600, 2 bands, tracking at stride 2, vs JAX -------------
    t0 = time.perf_counter()
    with open(REF_BANDS_340) as f:
        bref = json.load(f)
    scene = write_cams(os.path.join(work, "scene340"), cams340)
    save = os.path.join(work, "out_bands340")
    cfg = torch_parity.write_child_config(
        os.path.join(work, "bands340.yaml"), torch_parity.reference_parent(bref),
        scene, save, bref["overrides"])
    (res, _, banded), la = counted(
        lambda: banded_run(cfg, priority_source=threefry.jax_priorities()))
    require_launches("phase 10a", la)
    got = torch_parity.summarize_run(save)
    check_entry(got, bref, ENTRY_REF_TOL, "phase 10a")
    for k, tol in (("banded_psnr", ENTRY_REF_TOL["final_psnr"]),
                   ("banded_depth_l1_cm", ENTRY_REF_TOL["depth_l1_cm"] + 0.01)):
        if not abs(banded[k] - bref[k]) <= tol:
            fail(f"phase 10a: {k} {banded[k]} vs JAX {bref[k]} (tol {tol})")
    mapper = res["mapper"]
    # JAX's count of this run, read where slam.py prints its line (the last
    # frame's lifecycle render not folded in), against the one JAX printed
    gap = abs(mapper.lifecycle_overflow - bref["max_overflow"])
    if not gap <= LIFECYCLE_OVERFLOW_RTOL * bref["max_overflow"]:
        fail(f"phase 10a: lifecycle overflow {mapper.lifecycle_overflow} vs JAX "
             f"{bref['max_overflow']} (rtol {LIFECYCLE_OVERFLOW_RTOL})")
    tm = band_timings(save, res)
    print(f"[phase 10a] {bref['height']}x{bref['width']} x {bref['frames']}, "
          f"{bref['overrides']['frame_bands']} bands of "
          f"{mapper.settings.height}x{mapper.settings.width}, tracking at "
          f"{track_shape(res)}: banded "
          f"final PSNR {banded['banded_psnr']} vs JAX {bref['banded_psnr']}, "
          f"depth L1 {banded['banded_depth_l1_cm']} vs "
          f"{bref['banded_depth_l1_cm']} cm; overflow {mapper.max_overflow}, "
          f"JAX's count (lifecycle renders) {mapper.lifecycle_overflow} vs "
          f"JAX's {bref['max_overflow']} (rtol {LIFECYCLE_OVERFLOW_RTOL}), the "
          f"feedback renders' {mapper.max_feedback_overflow}; median tracking "
          f"{tm['tracking_ms']} ms, mapping {tm['mapping_ms']} ms "
          f"(frames without a gradient pass), gradient frames "
          f"{tm['gradient_frames_ms']}; "
          f"launches {la}; {time.perf_counter() - t0:.1f} s ({smi})")

    # ---- 10d: the undersized 96x128 case of test_torch_overflow.py --------
    counts, works = [la, phase_10d(smi)], None

    # ---- 10b / 10c: room_full.yaml's keys on 6b's 680x1200 scene ----------
    for part, overrides in (("10b", {}), ("10c", BAND_FIT_CAPACITIES)):
        t0 = time.perf_counter()
        save = os.path.join(work, f"out_bands_full_{part}")
        cfg = torch_parity.write_child_config(
            os.path.join(work, f"bands_full_{part}.yaml"), ROOM_FULL_YAML,
            os.path.join(work, "scene_full"), save, overrides)
        args = read_config(cfg)
        captured, calls, restore = capture_optimize_launches(
            blend, optimize, first=("local",))
        blend.reset_launches()
        try:
            res, _, banded = banded_run(cfg, metric=False)
        finally:
            lb = dict(blend.launches)
            restore()
        counts.append(lb)
        mapper, ev = res["mapper"], res["final_eval"]
        n_bands = int(args.frame_bands)
        if banded["banded_n"] != n_bands or n_bands != 8:
            fail(f"phase {part}: {banded['banded_n']} bands, room_full.yaml has "
                 f"{n_bands}")
        overflow = (mapper.max_overflow, mapper.max_feedback_overflow,
                    ev["bin_overflow"])
        if overrides and any(overflow):
            fail(f"phase {part}: bin overflow (band renders, feedback renders, "
                 f"final eval) {overflow}")
        if not res["ate_cm"] <= BENCH_ATE_CM:
            fail(f"phase {part}: ATE {res['ate_cm']:.4f} cm > {BENCH_ATE_CM} cm")
        if not ev["psnr"] >= BENCH_PSNR:
            fail(f"phase {part}: banded final PSNR {ev['psnr']:.3f} < {BENCH_PSNR}")
        iters = sum(n for _, n, _ in calls)
        if iters < 1:
            fail(f"phase {part}: no gradient call (calls {calls})")
        require_launches(f"phase {part}", lb)
        require_launches(f"phase {part}", lb, KERNELS[1:2] + KERNELS[3:], iters)
        if set(captured.get("local", {})) != {"fwd", "bwd"}:
            fail(f"phase {part} made no local optimize launch of K1 and K2")
        tm = band_timings(save, res)
        st = mapper.settings
        per_kind = {}
        for kind, n, sec in calls:
            per_kind.setdefault(kind, []).append(round(sec * 1e3 / n, 2))
        print(f"[phase {part}] room_full.yaml{', ' + str(overrides) if overrides else ''}: "
              f"{len(tm['gradient_frames_ms']) + 1} gradient frames of "
              f"{len(res['tracker'].pose_es)}, {n_bands} bands of "
              f"{st.height}x{st.width} ({-(-st.height // 16)}x{-(-st.width // 16)} "
              f"tiles), tracking at {track_shape(res)}; ATE {res['ate_cm']:.4f} "
              f"cm, banded final PSNR {ev['psnr']:.3f} (printed "
              f"{banded['banded_psnr']}), depth L1 {ev['depth_l1_cm']:.4f} cm, "
              f"overflow (band renders, feedback renders, final eval) "
              f"{overflow}, gaussians "
              f"{mapper.get_stable_num + mapper.get_unstable_num}; median "
              f"tracking {tm['tracking_ms']} ms, mapping {tm['mapping_ms']} ms "
              f"(frames without a gradient pass), gradient frames "
              f"{tm['gradient_frames_ms']}; optimize calls "
              f"{[(k, n) for k, n, _ in calls]}, ms per iteration {per_kind}; "
              f"launches {lb}; {time.perf_counter() - t0:.1f} s ({smi})")
        if works is None:
            works = check_launch(
                f"phase {part} first local launch ({st.height}x{st.width} band)",
                captured["local"]["fwd"], captured["local"]["bwd"], smi)
    return add_counts(*counts), works


def phase_10d(smi):
    """F6 on the card: the port's lifecycle overflow count after every frame
    (folded and pending), before and after fold_overflow, and the gaussian
    counts against the JAX mapper's at undersized capacities
    (tests/test_torch_overflow.py's cases: whole frames, a mesh of
    MESH_SHARDS virtual shards of cuda:0, two row bands), all exact.
    Returns the launch counts."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_parity
    from rtgslam_torch.data.synthetic import make_cameras
    from rtgslam_torch.parallel import make_mesh

    counts = []
    for path, bands in (("whole", 1), ("mesh", 1), ("bands", 2)):
        t0 = time.perf_counter()
        ref_path = torch_parity.overflow_reference(96, 128, bands)
        with open(ref_path) as f:
            ref = json.load(f)
        cams = make_cameras(ref["frames"], ref["height"], ref["width"])
        mesh = make_mesh(devices=["cuda:0"] * MESH_SHARDS) if path == "mesh" else None
        (frames, before, after, wider), la = counted(
            lambda: torch_parity.port_overflow_run(ref, cams, "cuda:0", mesh))
        require_launches(f"phase 10d {path}", la, KERNELS[:1])
        counts.append(la)
        got = [(f["counts"], f["folded"], f["pending"]) for f in frames]
        want = [(f["counts"], f["folded"], f["pending"]) for f in ref["per_frame"]]
        if got != want:
            fail(f"phase 10d {path}: per frame (counts, folded, pending) {got} "
                 f"vs JAX {want}")
        if (before, after) != (ref["max_overflow_before_fold"],
                               ref["max_overflow_after_fold"]) or not after > 0:
            fail(f"phase 10d {path}: lifecycle overflow {before} / {after} "
                 f"before / after the fold vs JAX "
                 f"{ref['max_overflow_before_fold']} / "
                 f"{ref['max_overflow_after_fold']}")
        if not wider >= after:
            fail(f"phase 10d {path}: max_overflow {wider} < lifecycle {after}")
        print(f"[phase 10d] {path}, {ref['height']}x{ref['width']} x "
              f"{ref['frames']}, tile 64 / block 128, forward-only: lifecycle "
              f"overflow per frame {[f['folded'] for f in frames]} (pending "
              f"{[f['pending'] for f in frames]}), {before} / {after} before / "
              f"after the fold, equal to JAX's ({os.path.basename(ref_path)}); "
              f"the port's wider count {wider}; launches {la}; "
              f"{time.perf_counter() - t0:.1f} s ({smi})")
    return add_counts(*counts)


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


def filtered_run(label, fn):
    """counted(fn), failing unless fn's run launched the bilateral kernel
    once for every frame the tracker preprocessed with the depth filter on,
    and filtered a frame.  Returns (fn's result, its launch counts, the
    filtered frames)."""
    from rtgslam_torch.ops import preprocess
    from rtgslam_torch.slam import tracker

    plain = tracker.preprocess_frame
    sig = inspect.signature(plain)
    filtered = [0]

    def counting(*a, **k):
        filtered[0] += bool(sig.bind(*a, **k).arguments["use_filter"])
        return plain(*a, **k)

    preprocess.reset_launches()
    tracker.preprocess_frame = counting
    try:
        out, launches = counted(fn)
    finally:
        tracker.preprocess_frame = plain
    n = preprocess.launches["bilateral"]
    if not n == filtered[0] >= 1:
        fail(f"{label}: the bilateral kernel launched {n} times for "
             f"{filtered[0]} filtered frames")
    return out, launches, n


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
    counts, check_launch's result on the run's local optimize launch, the
    bilateral kernel's launches)."""
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
    (res, _), la, fa = filtered_run(
        "phase 7a 170x300", lambda: run_entry_points(cfg, threefry.jax_priorities()))
    require_launches("phase 7a 170x300", la)
    if res["mapper"].max_overflow != oref["max_overflow"]:
        fail(f"phase 7a: overflow {res['mapper'].max_overflow}")
    summary = torch_parity.summarize_run(save)
    check_entry(summary, oref, ORB_REF_TOL, "phase 7a 170x300")
    with open(REF_ORB_SPREAD) as f:
        spread = json.load(f)
    if not spread["min"] <= summary["psnr"] <= spread["max"]:
        fail(f"phase 7a: final keyframe PSNR {summary['psnr']:.4f} outside JAX's "
             f"own spread [{spread['min']:.4f}, {spread['max']:.4f}] over "
             f"{len(spread['runs'])} runs")
    print(f"[phase 7a] final keyframe PSNR {summary['psnr']:.4f} inside JAX's "
          f"own spread [{spread['min']:.4f}, {spread['max']:.4f}] "
          f"({len(spread['runs'])} runs, {os.path.basename(REF_ORB_SPREAD)})")
    print(f"[phase 7a] 170x300: tracker {dict(res['tracker'].status)}, "
          f"launches {la}, bilateral {fa}; {time.perf_counter() - t0:.1f} s "
          f"({smi})")

    t0 = time.perf_counter()
    cams = loop_sequence(make_cameras(LOOP_OUT, TUM_H, TUM_W))
    print(f"[phase 7a] {len(cams)} cameras at {TUM_H}x{TUM_W} in "
          f"{time.perf_counter() - t0:.1f} s ({smi})")
    args = make_args(TUM_H, TUM_W)
    for k, v in dict(torch_parity.TUM_KEYS, **LOOP_KEYS).items():
        setattr(args, k, v)
    spent, untime = time_methods([(IcpTracker, "predict_pose"),
                                  (Tracker, "_refine_with_backend"),
                                  (LoopCloser, "observe")])
    captured, calls, restore = capture_optimize_launches(blend, optimize)
    t0 = time.perf_counter()
    try:
        res, lb, fb = filtered_run(f"phase 7a {TUM_H}x{TUM_W}",
                                   lambda: run_sequence(args, cams, dev))
    finally:
        restore()
        untime()
    if fb != len(cams):
        fail(f"phase 7a: {fb} filtered frames of {len(cams)}")
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
    track, mapping = check_slice(res, f"phase 7a {TUM_H}x{TUM_W}", smi)
    split = {k: median(v) * 1e3 for k, v in spent.items()}
    print(f"[phase 7a] {TUM_H}x{TUM_W}, {len(cams)} frames: tracker {status}; "
          f"median tracking {track:.2f} ms = ICP solve {split['predict_pose']:.2f}"
          f" + backend {split['_refine_with_backend']:.2f} + loop check "
          f"{split['observe']:.2f} (slowest {max(spent['observe']) * 1e3:.2f}) "
          f"+ the rest; median mapping {mapping:.2f} ms; launches {lb} for "
          f"{iters} gradient iterations, bilateral {fb} (one a frame); run "
          f"{run_s:.1f} s ({smi})")
    if set(captured.get("local", {})) != {"fwd", "bwd"}:
        fail("phase 7a made no local optimize launch of K1 and K2")
    works = check_launch(f"phase 7a {TUM_H}x{TUM_W} local optimize launch",
                         captured["local"]["fwd"], captured["local"]["bwd"], smi)
    return add_counts(la, lb), works, fa + fb


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
              f"{time.perf_counter() - t0:.1f} s ({smi})")
    a, b = summaries
    for k in ("ate_cm", "psnr", "depth_l1_cm", "checkpoint_rows", "csv_mean"):
        if a[k] != b[k]:
            fail(f"phase 7b: two strict/1 runs differ in {k}: {a[k]} vs {b[k]}")
    check_entry(a, mref, ENTRY_REF_TOL, "phase 7b 170x300 strict/1")

    scene = os.path.join(work, "scene_full")
    with open(os.path.join(work, "out_full", "performance.json")) as f:
        single = json.load(f)["samples"]
    n = MP_FULL_FRAMES
    single_ms = sum(single["tracking"][1:n] + single["mapping"][1:n]) * 1e3 / (n - 1)
    for sync in ("strict", "free"):
        t0 = time.perf_counter()
        save = os.path.join(work, f"out_mp_full_{sync}")
        cfg = torch_parity.write_child_config(
            os.path.join(work, f"mp_full_{sync}.yaml"), ROOM_FULL_YAML, scene,
            save, dict(FULL_OVERRIDES, sync_tracker2mapper_method=sync))
        res, lc = counted(lambda: slam_mp_torch.main(
            ["--config", cfg, "--frames", str(MP_FULL_FRAMES)]))
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
        mid = {f"frame_{t:04d}" for t in range(MP_FULL_FRAMES)
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
              f"mapping {single_ms:.2f} ms per frame (frames 1..{n - 1}); "
              f"launches {lc}; "
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
    print(f"[phase 7c] {time.perf_counter() - t0:.1f} s ({smi})")
    return lc, works


def phase_8_subprocess(smi):
    """bench_torch.py as a subprocess at its default 170x300 x 40 with one
    rep and RTG_PERF=1: exit 0, the JSON keys, the gates, ``detail.perf``."""
    import bench_torch

    t0 = time.perf_counter()
    env = dict(os.environ, BENCH_REPS="1", RTG_PERF="1")
    for k in ("BENCH_PLATFORM", "BENCH_H", "BENCH_W", "BENCH_FRAMES",
              "BENCH_WARMUP", "RTG_TRACE"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py")],
                          cwd=REPO, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        fail(f"phase 8: bench_torch.py exited {proc.returncode}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    d = line.get("detail", {})
    if set(line) != BENCH_KEYS or set(d) != BENCH_DETAIL_KEYS:
        fail(f"phase 8: bench_torch.py keys {sorted(line)} / {sorted(d)}")
    if line["metric"] != bench_torch.METRIC or line["unit"] != "fps":
        fail(f"phase 8: metric {line['metric']} in {line['unit']}")
    if (d["H"], d["W"], d["frames"], d["reps"]) != bench_torch.DEFAULT_SIZE + (1,):
        fail(f"phase 8: ran {d['H']}x{d['W']} x {d['frames']} frames, {d['reps']} reps")
    if not (d["psnr"] >= 27.5 and d["ate_cm"] <= 0.5 and d["bin_overflow"] == 0):
        fail(f"phase 8: gates psnr {d['psnr']} ate {d['ate_cm']} overflow "
             f"{d['bin_overflow']}")
    if not d["lifecycle_overflow"] <= d["bin_overflow"]:
        fail(f"phase 8: JAX's overflow count {d['lifecycle_overflow']} above "
             f"the port's {d['bin_overflow']}")
    if not BENCH_SPANS <= set(d["perf"]):
        fail(f"phase 8: detail.perf lacks {sorted(BENCH_SPANS - set(d['perf']))}")
    spans = {k: (v["count"], v["median_ms"]) for k, v in d["perf"].items()}
    print(f"[phase 8] bench_torch.py (default 170x300 x 40, warm-up 12, 1 rep, "
          f"RTG_PERF=1) exit 0 in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps({k: v for k, v in line.items() if k != 'detail'})}; "
          f"{json.dumps({k: v for k, v in d.items() if k != 'perf'})}; host "
          f"spans (count, median ms) {spans} ({smi})")


def phase_8(cams, dev, smi):
    """bench_torch.py's reps in process on phase 5's 680x1200 frames with
    the launch counts reset just before.  Returns (launch counts,
    check_launch's result on the run's first local optimize launch, the
    run's mapper)."""
    import bench_torch
    from rtgslam_torch.models import optimize
    from rtgslam_torch.ops.rasterize import blend
    from rtgslam_torch.slam.run import make_args

    t0 = time.perf_counter()
    H, W = cams[0].image_height, cams[0].image_width
    args = make_args(H, W, env_overrides=True)
    captured, calls, restore = capture_optimize_launches(
        blend, optimize, first=("local",))
    try:
        (result, _, mapper), counts = counted(lambda: bench_torch.bench(
            args, copy.deepcopy(cams), BENCH_WARMUP_IN_PROCESS, 1, dev))
    finally:
        restore()
    d = result["detail"]
    renders = 2 * len(cams)   # lifecycle render per frame, spawn render from frame 1, eval
    iters = sum(n for _, n, _ in calls)
    if iters != args.gaussian_update_iter * len(mapper.optimize_frames_ids):
        fail(f"phase 8: {iters} gradient iterations in calls {calls}")
    for name, need in (("blend_fwd", renders), ("blend_fwd_residual", iters),
                       ("blend_fwd_transmission", 1), ("blend_bwd", iters),
                       ("blend_bwd_reduce", iters)):
        if counts[name] < need:
            fail(f"phase 8: {name} launched {counts[name]} times, needs {need}")
    vals = [result["value"], d["ate_cm"], d["psnr"], d["depth_l1_cm"]]
    if not all(math.isfinite(v) for v in vals) or d["bin_overflow"] != 0:
        fail(f"phase 8: {H}x{W} result {result}")
    if not d["ate_cm"] <= BENCH_ATE_CM or not d["psnr"] >= BENCH_PSNR:
        fail(f"phase 8: {H}x{W} ATE {d['ate_cm']} cm, PSNR {d['psnr']}")
    print(f"[phase 8] in process at {H}x{W} x {len(cams)} frames (warm-up "
          f"{BENCH_WARMUP_IN_PROCESS}, 1 rep): {json.dumps(result)}; launches "
          f"{counts} for {renders} renders and {iters} gradient iterations; "
          f"{time.perf_counter() - t0:.1f} s ({smi})")
    if set(captured.get("local", {})) != {"fwd", "bwd"}:
        fail("phase 8 made no local optimize launch of K1 and K2")
    works = check_launch("phase 8 first local optimize launch",
                         captured["local"]["fwd"], captured["local"]["bwd"], smi)
    return counts, works, mapper


def check_segment_sum(mapper, cam, dev, smi):
    """F3: ``accumulate_gaussian_error`` on the lifecycle's inputs for
    ``cam`` over ``mapper``'s map, twice on the card (bitwise equal) and
    once on the CPU (another summation order: within SEGMENT_RTOL of the
    largest total)."""
    import torch
    from rtgslam_torch.ops import segment

    out = mapper._render(cam.device_dict(dev))
    gt_color = torch.as_tensor(cam.image, device=dev)
    gt_d = torch.as_tensor(cam.depth, device=dev)[..., 0]
    depth_err = torch.clamp(gt_d - out["depth"][..., 0], min=0.0)
    color_err = torch.sum(torch.abs(gt_color - out["render"]), dim=-1)
    dix, cix = out["depth_index_map"], out["color_index_map"]
    depth_err = torch.where((gt_d == 0) | (dix < 0), 0.0, depth_err)
    color_err = torch.where(gt_d == 0, 0.0, color_err)
    inputs = (color_err, depth_err, depth_err * 0.5 + color_err, cix, dix,
              mapper.state.capacity)
    a = segment.accumulate_gaussian_error(*inputs)
    b = segment.accumulate_gaussian_error(*inputs)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("F3: two runs of accumulate_gaussian_error on the card differ")
    cpu = segment.accumulate_gaussian_error(
        *[x.cpu() if torch.is_tensor(x) else x for x in inputs])
    rel = max(float((x.cpu() - y).abs().max() / y.abs().max().clamp(min=1e-30))
              for x, y in zip(a, cpu))
    if not rel <= SEGMENT_RTOL:
        fail(f"F3: the card's error sums differ from the CPU's by {rel:.3g} of "
             f"the largest")
    t = cuda_ms(lambda: segment.accumulate_gaussian_error(*inputs), 20)
    print(f"[F3] accumulate_gaussian_error on {int((cix >= 0).sum())} colour-hit "
          f"and {int((dix >= 0).sum())} depth-hit pixels over "
          f"{mapper.state.capacity} slots: two runs bitwise equal, the CPU's "
          f"sums within {rel:.3g} of the largest; {t:.4f} ms ({smi})")


def clone_state(state):
    import dataclasses

    return type(state)(**{f.name: getattr(state, f.name).clone()
                          for f in dataclasses.fields(state)})


def keep_last_local_call(optimize):
    """Patch ``optimize.optimize_execute`` to keep the arguments of the
    latest local call, its map state cloned before the call.  Returns
    (kept, restore)."""
    orig = optimize.optimize_execute
    sig = inspect.signature(orig)
    kept = {}

    @functools.wraps(orig)   # its signature, for capture_optimize_launches
    def call(*a, **k):
        bound = sig.bind(*a, **k).arguments
        if bound["mode"] == "local":
            kept.clear()
            kept.update(bound, state=clone_state(bound["state"]))
        return orig(*a, **k)

    optimize.optimize_execute = call

    def restore():
        optimize.optimize_execute = orig
    return kept, restore


def within(got, want, rtol, atol):
    """The largest of |got - want| - (atol + rtol |want|) (<= 0 passes)."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def phase_9(mapper, args, cams, kept_local, local_ms, dev, smi):
    """The multi-device path on MESH_SHARDS virtual shards of ``dev`` with
    phase 5's map and frames (9a-9d in the module docstring).  Returns
    (launch counts of 9a-9d, check_inference's result on 9a's shard 0,
    check_launch's result on 9d's first local launch)."""
    import numpy as np
    import torch
    from rtgslam_torch.config import OptimizationParams
    from rtgslam_torch.models import optimize
    from rtgslam_torch.models.gaussian_map import (UNSTABLE, alive_mask,
                                                   render_inputs)
    from rtgslam_torch.ops.rasterize import api, blend
    from rtgslam_torch.parallel import (dp_global_optimize, dp_local_optimize,
                                        make_mesh, sp_render)
    from rtgslam_torch.parallel.sp_optimize import sp_optimize_execute
    from rtgslam_torch.slam import mapper as mapper_mod
    from rtgslam_torch.slam.run import make_args, run_sequence

    t_phase = time.perf_counter()
    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    n = mesh.size
    st = mapper.settings

    # ---- 9a: the tile-sharded render of the final map ----------------------
    camera = cams[-1].device_dict(dev)
    gauss = render_inputs(mapper.state, alive_mask(mapper.state))
    want = api.render(gauss, camera, st)
    shard_args, orig = [], blend.blend_tiles

    def keep(*a, **k):
        shard_args.append(a)
        return orig(*a, **k)

    blend.blend_tiles = keep
    try:
        got, la = counted(lambda: sp_render(gauss, camera, st, mesh))
    finally:
        blend.blend_tiles = orig
    for k in want:
        if not torch.equal(got[k], want[k]):
            fail(f"phase 9a: sp_render's {k} differs from render's")
    if la["blend_fwd"] != n or sum(la.values()) != n:
        fail(f"phase 9a: launches {la}, not K1 once per shard")
    inf = check_inference(f"phase 9a sp_render shard 0 of {n}", shard_args[0], smi)
    ms_sp = cuda_ms(lambda: sp_render(gauss, camera, st, mesh), 10)
    ms_one = cuda_ms(lambda: api.render(gauss, camera, st), 10)
    print(f"[phase 9a] sp_render over {n} shards of {dev}: the seven maps, "
          f"the normal and the overflow bitwise equal to render's; "
          f"{int(want['overflow'])} overflow; K1 launches {la['blend_fwd']} "
          f"(tiles {tuple(shard_args[0][2].shape)} per shard); {ms_sp:.3f} ms "
          f"vs render {ms_one:.3f} ms ({smi})")

    # ---- 9b: the same frame on every shard vs the one-device chain ---------
    opt = OptimizationParams().extract(args)
    lrs, weights = mapper._lrs(opt), mapper._weights(opt)
    rec = mapper.processed_frames[-1]
    fm = rec["frame_map"]
    entry = mapper._entry(rec["camera"], fm["color_map"], fm["depth_map"],
                          fm["normal_map_w"])
    one = mapper._stack_entries([entry])
    many = mapper._stack_entries([entry] * n)
    counts9 = [la]
    for mode in ("local", "global"):
        base = clone_state(mapper.state)
        if mode == "local":      # the final pass fixed every gaussian
            base.status[alive_mask(base)] = UNSTABLE
        dp, chain = clone_state(base), clone_state(base)
        merge = mapper.history_merge_max_weight if mode == "local" else 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "local":
            _, lb = counted(lambda: dp_local_optimize(
                dp, *many, DP_STEPS, lrs, weights, st, mesh, False, merge))
        else:
            _, lb = counted(lambda: dp_global_optimize(
                dp, *many, DP_STEPS, lrs, weights, st, mesh, -1.0, False))
        torch.cuda.synchronize()
        dp_s = time.perf_counter() - t0
        optimize.optimize_chain(chain, *one, np.zeros(DP_STEPS, np.int64),
                                DP_STEPS, lrs, weights, st, mode, -1.0, False,
                                merge)
        torch.cuda.synchronize()
        chain_s = time.perf_counter() - t0 - dp_s
        for k in optimize.PARAM_KEYS:
            a, b = getattr(dp, k), getattr(chain, k)
            if not torch.equal(a, b):
                fail(f"phase 9b {mode}: {k} differs from the one-device chain "
                     f"at {int((a != b).sum())} entries (max "
                     f"{float((a - b).abs().max()):.3g}): the mesh's mean is "
                     f"not the one-frame gradient")
        want_conf = chain.confidence if mode == "local" else base.confidence
        if not torch.equal(dp.confidence, want_conf):
            fail(f"phase 9b {mode}: the confidence differs")
        require_launches(f"phase 9b {mode}", lb, KERNELS[1:2] + KERNELS[3:],
                         DP_STEPS * n)
        require_launches(f"phase 9b {mode}", lb, KERNELS[2:3], n)   # masks
        moved = int((dp.features_dc != base.features_dc).any(-1).sum())
        counts9.append(lb)
        print(f"[phase 9b] dp_{mode}_optimize, the last frame on {n} shards, "
              f"{DP_STEPS} iterations at {st.height}x{st.width}: parameters "
              f"{'and confidence ' if mode == 'local' else ''}bitwise equal to "
              f"optimize_chain on that frame ({moved} gaussians moved); "
              f"launches {lb}; {dp_s * 1e3 / DP_STEPS:.2f} ms per iteration "
              f"vs the chain's {chain_s * 1e3 / DP_STEPS:.2f} (masks "
              f"included) ({smi})")

    # ---- 9c: the tile-sharded compact loop on phase 5's last local call -----
    if not kept_local:
        fail("phase 9c: phase 5 made no local optimize call")
    call = dict(kept_local, n_iters=SP_ITERS,
                frame_seq=list(kept_local["frame_seq"])[:SP_ITERS])
    ref, sp = clone_state(call["state"]), clone_state(call["state"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_r = optimize.optimize_execute(**dict(call, state=ref))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    got_r, lc = counted(lambda: sp_optimize_execute(**dict(call, state=sp),
                                                    mesh=mesh))
    torch.cuda.synchronize()
    sp_s = time.perf_counter() - t0 - one_s
    rtol, atol = SP_TOL["report"]
    for k in optimize.REPORT_KEYS:
        if not abs(float(got_r[k]) - float(want_r[k])) <= atol + rtol * abs(float(want_r[k])):
            fail(f"phase 9c: report {k} {float(got_r[k]):.6g} vs "
                 f"{float(want_r[k]):.6g} (rtol {rtol}, atol {atol})")
    rtol, atol = SP_TOL["params"]
    excess = {k: within(getattr(sp, k), getattr(ref, k), rtol, atol)
              for k in ("xyz", "opacity", "scaling", "features_dc")}
    for k, e in excess.items():
        if e > 0:
            fail(f"phase 9c: {k} beyond rtol {rtol} / atol {atol} of the "
                 f"one-device loop by {e:.3g}")
    if not torch.equal(sp.confidence, ref.confidence):
        fail("phase 9c: the confidence differs from the one-device loop's")
    # K1's residual mode and K2 on every shard, one reduce of all partials
    require_launches("phase 9c", lc, KERNELS[1:2] + KERNELS[3:4], SP_ITERS * n)
    require_launches("phase 9c", lc, KERNELS[4:], SP_ITERS)
    counts9.append(lc)
    rep_gap = max(abs(float(got_r[k]) - float(want_r[k]))
                  for k in optimize.REPORT_KEYS)
    bitwise = all(torch.equal(getattr(sp, k), getattr(ref, k))
                  for k in optimize.PARAM_KEYS + ("confidence",))
    print(f"[phase 9c] sp_optimize_execute over {n} shards on phase 5's last "
          f"local call (tile rows {tuple(call['tile_rows'].shape)}, lists "
          f"{tuple(call['lists_orig'].shape)}, pool {call['n_pool']}), "
          f"{SP_ITERS} iterations: report within {rep_gap:.3g}, parameters "
          f"within {SP_TOL['params']} (largest excess "
          f"{max(excess.values()):.3g}), confidence equal; the map "
          f"{'bitwise equal' if bitwise else 'NOT bitwise equal'} to the "
          f"one-device loop's; launches {lc}; "
          f"{sp_s * 1e3 / SP_ITERS:.2f} ms per iteration vs "
          f"{one_s * 1e3 / SP_ITERS:.2f} on one device ({smi})")

    # ---- 9d: the mapper on the mesh over phase 5's frames -------------------
    args9 = make_args(st.height, st.width)
    for k, v in FULL_OVERRIDES.items():
        setattr(args9, k, v)
    args9.gaussian_update_iter = MESH_ITERS
    args9.multi_device = True
    captured, calls, restore = capture_optimize_launches(
        blend, None, first=("local",), targets=(
            (mapper_mod, "dp_local_optimize", lambda b: ("local", b["n_steps"])),
            (mapper_mod, "dp_global_optimize",
             lambda b: ("global", b["n_steps"]))))
    t0 = time.perf_counter()
    try:
        res, ld = counted(lambda: run_sequence(args9, copy.deepcopy(cams), dev,
                                               mesh=mesh))
    finally:
        restore()
    run_s = time.perf_counter() - t0
    if res["max_overflow"] != 0:
        fail(f"phase 9d: bin overflow {res['max_overflow']}")
    if not res["ate_cm"] <= BENCH_ATE_CM:
        fail(f"phase 9d: ATE {res['ate_cm']:.4f} cm > {BENCH_ATE_CM} cm")
    if not res["eval"]["psnr"] >= BENCH_PSNR:
        fail(f"phase 9d: PSNR {res['eval']['psnr']:.3f} < {BENCH_PSNR}")
    kinds = [k for k, _, _ in calls]
    if kinds.count("local") < 1 or kinds.count("global") < 1:
        fail(f"phase 9d: optimize calls on the mesh {calls}, need a local and "
             f"a windowed global one")
    iters = sum(it for _, it, _ in calls)
    require_launches("phase 9d", ld)
    require_launches("phase 9d", ld, KERNELS[1:2] + KERNELS[3:], iters * n)
    if set(captured.get("local", {})) != {"fwd", "bwd"}:
        fail("phase 9d made no local launch of K1 and K2 on the mesh")
    counts9.append(ld)
    track, mapping = check_slice(res, f"phase 9d {st.height}x{st.width} on {n} shards", smi)
    per_it = ", ".join(f"{k} {s_ * 1e3 / it:.2f}" for k, it, s_ in calls)
    print(f"[phase 9d] mapper with mesh= {n} shards of {dev}, multi_device "
          f"on, FULL_OVERRIDES, {MESH_ITERS} iterations per call: calls "
          f"{[(k, it) for k, it, _ in calls]}; ms per iteration on the mesh "
          f"(masks included) {per_it} vs phase 5's compact local calls "
          f"{', '.join(f'{x:.2f}' for x in local_ms)}; median tracking "
          f"{track:.2f} ms, mapping {mapping:.2f} ms per frame; launches {ld}; "
          f"run {run_s:.1f} s ({smi})")
    works = check_launch(f"phase 9d first dp-local launch (shard 0 of {n})",
                         captured["local"]["fwd"], captured["local"]["bwd"], smi)
    print(f"[phase 9] {time.perf_counter() - t_phase:.1f} s ({smi})")
    return add_counts(*counts9), inf, works


def profiled_filters(depths, reps):
    """One torch.profiler session over the bilateral kernel once and its
    plain loop ``reps`` times at each of ``depths`` (a process that
    profiles more than once loses events, so this is the only session).
    Returns, per depth, (the kernel's launches, the loop's launches per
    call, the median of the loop's summed device ms).  Copies and memsets
    are left out, as benchmark/trace.py counts; the sum is the device's own
    work, whatever the host's enqueue leaves it waiting between kernels."""
    import torch
    from rtgslam_torch.ops import preprocess
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for depth in depths:
            preprocess.bilateral_filter(depth)
            torch.cuda.synchronize()
            for _ in range(reps):
                preprocess.bilateral_filter_plain(depth)
                torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset", "Memory"))),
                 key=lambda e: e.time_range.start)
    # each kernel launch opens the group of the loop's calls that follow it
    groups = []
    for e in evs:
        if "bilateral_kernel" in e.name:
            groups.append([])
        elif not groups:
            fail(f"phase 3f: {e.name} ran before the first bilateral kernel")
        else:
            groups[-1].append(e.time_range.elapsed_us() * 1e-3)
    if len(groups) != len(depths):
        fail(f"phase 3f: the profile holds {len(groups)} bilateral kernels, "
             f"{len(depths)} launched")
    out = []
    for g in groups:
        if len(g) % reps:
            fail(f"phase 3f: {len(g)} kernels of the plain loop in {reps} calls")
        n = len(g) // reps
        out.append((1, n, median(sum(g[i * n:(i + 1) * n]) for i in range(reps))))
    return out


def phase_3f(dev, smi):
    """The bilateral filter's kernel against its plain loop (docstring, 3f).
    Returns a row per size for the kernels line."""
    import torch
    from rtgslam_torch.ops import preprocess
    from rtgslam_torch.utils import cuda_build

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_parity as tp

    t0 = time.perf_counter()
    preprocess._bilateral_lib()
    info = cuda_build.build_info["bilateral"]
    print(f"[phase 3f] built bilateral in {info['seconds']:.2f} s ({smi})")
    print(info["ptxas"].strip())
    gen = torch.Generator(device=dev).manual_seed(20)
    depths = [tp.kinect_depth("fr1_desk", 480, 640, dev, gen),
              tp.kinect_depth("orbit", 680, 1200, dev, gen)]
    preprocess.reset_launches()
    rows = []
    for depth in depths:
        H, W = depth.shape
        got = preprocess.bilateral_filter(depth)
        want = preprocess.bilateral_filter_plain(depth)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"phase 3f {H}x{W}: the bilateral kernel differs from its plain "
                 f"loop at {int((got != want).sum())} pixels")
        ms = cuda_ms(lambda: preprocess.bilateral_filter(depth), 200)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            preprocess.bilateral_filter_plain(depth)
            torch.cuda.synchronize()
        plain_host_ms = (time.perf_counter() - t1) / 5 * 1e3
        t1 = time.perf_counter()
        for _ in range(50):
            preprocess.bilateral_filter(depth)
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t1) / 50 * 1e3
        bound_ms, by = bound(BILATERAL_OPS * H * W, 8 * H * W)
        rows.append({"kernel": "bilateral", "shape": [H, W], "ms": ms,
                     "bound_ms": bound_ms, "bound_by": by, "share": bound_ms / ms,
                     "host_ms": host_ms, "plain_host_ms": plain_host_ms})
    # the loop's 900 launches overflow the launch queue, so its time under
    # cuda_ms would be the host's enqueue: sum its kernels instead
    for row, (kernels, plain_kernels, plain_ms) in zip(
            rows, profiled_filters(depths, 3)):
        if (kernels, plain_kernels) != (1, PLAIN_FILTER_KERNELS):
            fail(f"phase 3f {row['shape']}: {kernels} kernel and "
                 f"{plain_kernels} loop kernels, not 1 and {PLAIN_FILTER_KERNELS}")
        row.update(plain_ms=plain_ms, kernels=kernels, plain_kernels=plain_kernels)
        print(f"[phase 3f] {row['shape'][0]}x{row['shape'][1]}: bitwise the "
              f"plain loop; " + json.dumps(row))
    rows[0]["launches"] = preprocess.launches["bilateral"]
    print(f"[phase 3f] {time.perf_counter() - t0:.1f} s ({smi})")
    return rows


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
        print(f"[phase 2] built {name} in {info['seconds']:.2f} s ({smi})")
        print(info["ptxas"].strip())
    cuda_build.build_host("pose_backend")
    print(f"[phase 2] built the pose backend (g++) in "
          f"{cuda_build.build_info['pose_backend']['seconds']:.2f} s ({smi})")
    print(f"[phase 2] {time.perf_counter() - t0:.2f} s ({smi})")

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
          f"two launches; phase 3 {time.perf_counter() - t0:.1f} s ({smi})")

    # ---- phase 3f: the bilateral depth filter vs its plain loop ---------------
    filt = phase_3f(dev, smi)

    # ---- phase 4: forward-only loop at 170x300 vs the JAX reference ----------
    t0 = time.perf_counter()
    cams170 = make_cameras(FRAMES, 170, 300)
    args = make_args(170, 300)
    args.gaussian_update_iter = 0
    args.final_global_iter = 0
    res = run_sequence(args, copy.deepcopy(cams170), dev, threefry.jax_priorities())
    check_slice(res, "phase 4 170x300 forward-only", smi)
    check_reference(res, REF_170, REF_TOL, "phase 4")
    print(f"[phase 4] {time.perf_counter() - t0:.1f} s ({smi})")

    # ---- phase 4b: the loop with optimization at 170x300 ---------------------
    t0 = time.perf_counter()
    res = run_sequence(make_args(170, 300), copy.deepcopy(cams170), dev,
                       threefry.jax_priorities())
    check_slice(res, "phase 4b 170x300 optimize", smi)
    check_reference(res, REF_OPT_170, OPT_REF_TOL, "phase 4b")
    print(f"[phase 4b] {time.perf_counter() - t0:.1f} s ({smi})")

    # ---- phase 4c: the loop with optimization at 340x600 -------------------
    t0 = time.perf_counter()
    cams340 = make_cameras(FRAMES, 340, 600)
    res = run_sequence(make_args(340, 600), copy.deepcopy(cams340), dev,
                       threefry.jax_priorities())
    check_slice(res, "phase 4c 340x600 optimize", smi)
    check_reference(res, REF_OPT_340, OPT_REF_TOL, "phase 4c")
    print(f"[phase 4c] {time.perf_counter() - t0:.1f} s ({smi})")

    # ---- phase 5: the main path at 680x1200 -------------------------------
    t0 = time.perf_counter()
    args = make_args(680, 1200)
    if args.map_capacity != 1 << 19:
        fail(f"map capacity {args.map_capacity} != 2^19")
    cams = make_cameras(FRAMES, 680, 1200)
    print(f"[phase 5] cameras {time.perf_counter() - t0:.1f} s ({smi})")
    t0 = time.perf_counter()
    kept_local, unkeep = keep_last_local_call(optimize)
    captured, calls, restore = capture_optimize_launches(blend, optimize)
    blend.reset_launches()
    res = run_sequence(args, copy.deepcopy(cams), dev)
    launches = dict(blend.launches)
    restore()
    unkeep()
    run_s = time.perf_counter() - t0
    track_ms, map_ms = check_slice(res, "phase 5 680x1200", smi)
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
          f"kind: {per_kind}); run {run_s:.1f} s ({smi})")
    for kind in sorted({k for k, _, _ in calls}):
        each = ", ".join(f"{s * 1e3 / n:.2f}" for k, n, s in calls if k == kind)
        print(f"[phase 5] optimize loop, {kind} calls: ms per iteration "
              f"(setup included) {each} ({smi})")

    # ---- phase 5r: phase 5's frames with JAX's priorities, vs JAX ----------
    t0 = time.perf_counter()
    res_r, launches_r = counted(lambda: run_sequence(
        make_args(680, 1200), copy.deepcopy(cams), dev, threefry.jax_priorities()))
    require_launches("phase 5r", launches_r)
    track_r, map_r = check_slice(res_r, "phase 5r 680x1200, JAX's priorities", smi)
    check_reference(res_r, REF_OPT_680, OPT_REF_TOL, "phase 5r")

    def grad_ms(r):
        return {i: round(r["map_ms"][i], 1) for i in r["optimize_frames"]}

    print(f"[phase 5r] beside phase 5: median tracking {track_r:.2f} vs "
          f"{track_ms:.2f} ms, mapping {map_r:.2f} vs {map_ms:.2f} ms, "
          f"gradient frames {grad_ms(res_r)} vs {grad_ms(res)} ms, final pass "
          f"{res_r['final_ms']:.1f} vs {res['final_ms']:.1f} ms; JAX's overflow "
          f"count {res_r['lifecycle_overflow']}; launches {launches_r}; "
          f"{time.perf_counter() - t0:.1f} s ({smi})")
    del res_r

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
    print(f"[phase 3b/3e] {time.perf_counter() - t0:.1f} s ({smi})")

    by_phase = {"5": launches, "5r": launches_r}
    by_phase["9"], inf9, works["mesh"] = phase_9(
        mapper, args, cams, kept_local,
        [s_ * 1e3 / n for k, n, s_ in calls if k == "local"], dev, smi)
    del kept_local
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        phase_6a(work, smi)
        by_phase["6b"], works["global"] = phase_6b(work, cams, dev, smi)
        by_phase["10"], works["band"] = phase_10(work, cams340, smi)
        by_phase["7b"] = phase_7b(work, dev, smi)
        by_phase["7c"], works["frozen"] = phase_7c(mapper, args, smi)
        by_phase["7a"], works["tum"], filt7a = phase_7a(work, dev, smi)
    phase_8_subprocess(smi)
    by_phase["8"], works["bench"], mapper8 = phase_8(cams, dev, smi)
    check_segment_sum(mapper8, cams[-1], dev, smi)
    print(f"[done] {time.perf_counter() - t_start:.1f} s ({smi})")

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
        entry("blend_fwd", "blend_fwd.cu", "60", inf,
              max(err_rand, inf["err"], inf9["err"])),
        entry("blend_fwd_residual", "blend_fwd.cu", "60", loc["res"],
              max(err_res, err("res"))),
        entry("blend_fwd_transmission", "blend_fwd.cu", "60", trans,
              max(err_trans, trans["err"])),
        entry("blend_bwd", "blend_bwd.cu", "180", loc["bwd"],
              max(err_bwd, err("bwd"))),
        entry("blend_bwd_reduce", "blend_bwd.cu", "180", loc["reduce"],
              max(err_red, err("reduce"))),
        # bitwise its loop; timed at TUM's 480x640 (phase 3f), launched on
        # the main path by phase 7a alone (the one phase with the filter on)
        {"name": "bilateral", "route": "cuda", "source": src + "bilateral.cu",
         "replaces": "rtgslam_tpu/ops/preprocess.py:85", "launches": filt7a,
         "max_abs_err": 0.0, "ms": filt[0]["ms"], "plain_ms": filt[0]["plain_ms"],
         "bound_ms": filt[0]["bound_ms"], "bound_by": filt[0]["bound_by"],
         "library_ms": None,
         "launches_by_phase": {"3f": filt[0]["launches"], "7a": filt7a}},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
