#!/usr/bin/env python3
"""Drive the PyTorch port (``rtgslam_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and nothing falls back to the CPU):
  1.  require a CUDA device; print the card's name and power limit;
  2.  build kernels K1 (csrc/blend_fwd.cu) and K2 (csrc/blend_bwd.cu) from
      the sources, one nvcc each, started together, and print the seconds;
  3a. hold K1's inference mode against its plain PyTorch twin on random tiles;
  3c. K1's residual mode (maps, entry T, done) and transmission mode (T, the
      mask T != 1 exact) against their twins on random tiles;
  3d. K2 against the plain backward on random tiles;
  4.  the forward-only loop (both iteration counts 0) at 170x300 x 12
      frames against the JAX-on-CPU reference tests/data/slice_170x300_jax_cpu.json;
  4b. the loop with gradient optimization (bench.make_args unchanged) at
      170x300 x 12 frames against tests/data/slice_opt_170x300_jax_cpu.json;
  5.  the bench point with optimization at 680x1200 x 12 frames (map
      capacity 2^19) with the launch counts reset just before: overflow 0,
      finite metrics, ATE <= 1 cm, PSNR >= 27.5, K1 launched at least once
      per render and per iteration, K2 once per iteration; the run keeps
      the inputs of the first K1 residual and K2 launches of its last local
      optimize call and of its final pass, and times every optimize call;
  3b. K1's inference mode against its twin on that map's last frame;
  3e. K1's transmission mode against its twin on the stable pool's mask
      render of that map, and K1's residual mode and K2 against theirs on
      the launches phase 5 kept (the local pass's compact lists, the final
      pass's full lists), with times at those shapes;
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
      mode and K2 against their twins on the global call's own launches.
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
ROOM_FULL_YAML = os.path.join(REPO, "configs", "synthetic", "room_full.yaml")
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
# in another order (warp shuffles, then atomics across tiles whose order
# changes from run to run) on transmittances that differ by rounding
BWD_RTOL, BWD_FLOOR = 1e-4, 1e-6
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
# rendered after the windowed global call and the final pass, moves with
# the summation order of K2's atomics: six runs of the port on one H100 gave
# 34.51-35.05 dB against the reference's 35.03; the metric CSV's mean PSNR
# over all 12 frames stays within OPT_REF_TOL's 0.3 (it came within 0.16)
ENTRY_REF_TOL = dict(OPT_REF_TOL, final_psnr=0.8)
BENCH_ATE_CM, BENCH_PSNR = 1.0, 27.5


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_tiles(device, T=384, Kt=512, V=20000, seed=0):
    """Random depth-sorted feature rows and ascending per-tile lists."""
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


def compare_residuals(entry, done, ref_entry, ref_done, t_threshold):
    """Max abs error of K1's entry T against the twin's.  ``done`` must be
    equal except where the tile's max T at the exit test sits within
    BLEND_ATOL of the threshold (then the two round to opposite sides)."""
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
    return err, int(diff.sum())


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
    print(f"[{label}] ATE {res['ate_cm']:.4f} cm  PSNR {ev['psnr']:.3f}  "
          f"depth L1 {ev['depth_l1_cm']:.4f} cm  gaussians "
          f"{res['n_stable'] + res['n_unstable']}  overflow "
          f"{res['max_overflow']}  median tracking {track:.2f} ms (frames "
          f"1..{FRAMES - 1}), median mapping {mapping:.2f} ms (frames 1.."
          f"{FRAMES - 1} without a gradient pass)")
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
    reloaded final checkpoint, and K1's residual mode and K2 against their
    twins on the first windowed global call's launches.  Returns the
    launch counts of the run and (residual mode error, K2 error)."""
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
                       ("blend_fwd_transmission", 1), ("blend_bwd", iters6)):
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

    # K1's residual mode and K2 on the first windowed global call's launches
    fargs, bargs = captured6["global"]["fwd"], captured6["global"]["bwd"]
    out, entry, done = blend.blend_tiles(*fargs, residuals=True)
    ref, ref_entry, ref_done = blend.blend_tiles_reference(*fargs, residuals=True)
    torch.cuda.synchronize()
    e1, _, _ = compare_blend(out, ref, fargs[0], fargs[1], fargs[4], fargs[5])
    e2, n_edge = compare_residuals(entry, done, ref_entry, ref_done, fargs[6])
    e3, cols = compare_bwd(blend.blend_bwd(*bargs),
                           blend.blend_bwd_reference(*bargs), "phase 6b global")
    g_times = (cuda_ms(lambda: blend.blend_tiles(*fargs, residuals=True), 50),
               cuda_ms(lambda: blend.blend_tiles_reference(*fargs, residuals=True), 5),
               cuda_ms(lambda: blend.blend_bwd(*bargs), 50),
               cuda_ms(lambda: blend.blend_bwd_reference(*bargs), 5))
    walked = bargs[5]
    print(f"[phase 6b] windowed global optimize launch, {fargs[0].shape[0] - 1} "
          f"rows, lists {tuple(fargs[2].shape)}, tiles walking 1/2/3/4+ chunks "
          f"{[int((walked == c).sum()) for c in (1, 2, 3)]}/"
          f"{int((walked >= 4).sum())}: residual mode max abs err "
          f"{max(e1, e2):.3g} (done threshold ties {n_edge}), K1 "
          f"{g_times[0]:.4f} ms, plain {g_times[1]:.4f} ms; K2 max abs err "
          f"{e3:.3g}, per column err/largest: {cols}; K2 {g_times[2]:.4f} ms, "
          f"plain {g_times[3]:.4f} ms ({smi})")
    return launches6, (max(e1, e2), e3)


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
    print(f"[phase 2] {time.perf_counter() - t0:.2f} s")

    # ---- phase 3a: K1 inference vs plain on random tiles ---------------------
    t0 = time.perf_counter()
    feat, order, lists, counts, origins = random_tiles(dev)
    out = blend.blend_tiles(feat, order, lists, counts, origins, 0.6, 1e-4)
    ref = blend.blend_tiles_reference(feat, order, lists, counts, origins, 0.6, 1e-4)
    torch.cuda.synchronize()
    err_rand, ct, dt = compare_blend(out, ref, feat, order, origins, 0.6)
    print(f"[phase 3a] random tiles {tuple(lists.shape)}: max abs err "
          f"{err_rand:.3g}, index near-ties color {ct} depth {dt}")

    # ---- phase 3c: K1 residual and transmission modes on random tiles -------
    out, entry, done = blend.blend_tiles(feat, order, lists, counts, origins,
                                         0.6, 1e-4, residuals=True)
    ref, ref_entry, ref_done = blend.blend_tiles_reference(
        feat, order, lists, counts, origins, 0.6, 1e-4, residuals=True)
    torch.cuda.synchronize()
    err_res, _, _ = compare_blend(out, ref, feat, order, origins, 0.6)
    e, n_edge = compare_residuals(entry, done, ref_entry, ref_done, 1e-4)
    err_res = max(err_res, e)
    cols6 = feat[:, [0, 1, 2, 3, 4, 9]].contiguous()
    err_trans = compare_transmission(
        blend.blend_transmission(cols6, lists, counts, origins, 1e-4),
        blend.blend_transmission_reference(cols6, lists, counts, origins, 1e-4))
    print(f"[phase 3c] random tiles: residual mode max abs err {err_res:.3g} "
          f"(done differs at {n_edge} threshold ties), transmission mode "
          f"{err_trans:.3g}, mask T != 1 equal")

    # ---- phase 3d: K2 vs the plain backward on random tiles ------------------
    gc, gd, gt = random_cotangents(lists.shape[0], dev)
    bargs = (feat, order, lists, origins, ref_entry, ref_done, gc, gd,
             ref.T_final * gt, ref.depth_index, 0.6)
    err_bwd, cols = compare_bwd(blend.blend_bwd(*bargs),
                                blend.blend_bwd_reference(*bargs), "phase 3d")
    print(f"[phase 3d] random tiles: K2 max abs err {err_bwd:.3g}; per column "
          f"err/largest: {cols}; phase 3 {time.perf_counter() - t0:.1f} s")

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
                       ("blend_fwd_transmission", 1), ("blend_bwd", iters)):
        if launches[name] < need:
            fail(f"phase 5: {name} launched {launches[name]} times, needs {need}")
    if not res["ate_cm"] <= BENCH_ATE_CM:
        fail(f"phase 5: ATE {res['ate_cm']:.4f} cm > {BENCH_ATE_CM} cm")
    if not res["eval"]["psnr"] >= BENCH_PSNR:
        fail(f"phase 5: PSNR {res['eval']['psnr']:.3f} < {BENCH_PSNR}")
    print(f"[phase 5] launches {launches} for {renders} renders and {iters} "
          f"gradient iterations; run {run_s:.1f} s")
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
    out = blend.blend_tiles(*bargs)
    ref = blend.blend_tiles_reference(*bargs)
    torch.cuda.synchronize()
    err_real, ct, dt = compare_blend(out, ref, feat, bins.order, origins,
                                     st.opaque_threshold)
    k1_ms = cuda_ms(lambda: blend.blend_tiles(*bargs), 50)
    plain_ms = cuda_ms(lambda: blend.blend_tiles_reference(*bargs), 5)
    print(f"[phase 3b] 680x1200 frame, tile lists {tuple(bins.tile_lists.shape)}, "
          f"{int(bins.n_visible)} visible: max abs err {err_real:.3g}, index "
          f"near-ties color {ct} depth {dt}; K1 {k1_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({smi})")

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
    err_trans = max(err_trans, compare_transmission(
        blend.blend_transmission(*targs), blend.blend_transmission_reference(*targs)))
    trans_ms = cuda_ms(lambda: blend.blend_transmission(*targs), 50)
    trans_plain_ms = cuda_ms(lambda: blend.blend_transmission_reference(*targs), 5)
    print(f"[phase 3e] transmission mode, stable pool, lists "
          f"{tuple(tb.tile_lists.shape)}: max abs err {err_trans:.3g}; K1 "
          f"{trans_ms:.4f} ms, plain {trans_plain_ms:.4f} ms")

    # residual mode and K2 on the launches phase 5 made: the last local
    # call's compact lists and the final pass's full ones, with the run's
    # own cotangents
    times = {}
    for kind in ("local", "final"):
        if set(captured.get(kind, {})) != {"fwd", "bwd"}:
            fail(f"phase 5 made no {kind} optimize launch of K1 and K2")
        fargs, bargs = captured[kind]["fwd"], captured[kind]["bwd"]
        out, entry, done = blend.blend_tiles(*fargs, residuals=True)
        ref, ref_entry, ref_done = blend.blend_tiles_reference(
            *fargs, residuals=True)
        torch.cuda.synchronize()
        e1, _, _ = compare_blend(out, ref, fargs[0], fargs[1], fargs[4],
                                 fargs[5])
        e2, n_edge = compare_residuals(entry, done, ref_entry, ref_done,
                                       fargs[6])
        e3, cols = compare_bwd(blend.blend_bwd(*bargs),
                               blend.blend_bwd_reference(*bargs),
                               f"phase 3e {kind}")
        err_res, err_bwd = max(err_res, e1, e2), max(err_bwd, e3)
        times[kind] = (
            cuda_ms(lambda: blend.blend_tiles(*fargs, residuals=True), 50),
            cuda_ms(lambda: blend.blend_tiles_reference(*fargs, residuals=True), 5),
            cuda_ms(lambda: blend.blend_bwd(*bargs), 50),
            cuda_ms(lambda: blend.blend_bwd_reference(*bargs), 5))
        walked = bargs[5]
        print(f"[phase 3e] {kind} optimize launch, {fargs[0].shape[0] - 1} "
              f"rows, lists {tuple(fargs[2].shape)}, tiles walking 1/2/3/4+ "
              f"chunks {[int((walked == c).sum()) for c in (1, 2, 3)]}/"
              f"{int((walked >= 4).sum())}: residual mode max abs err "
              f"{max(e1, e2):.3g} (done threshold ties {n_edge}), K1 "
              f"{times[kind][0]:.4f} ms, plain {times[kind][1]:.4f} ms; K2 "
              f"max abs err {e3:.3g}, per column err/largest: {cols}; K2 "
              f"{times[kind][2]:.4f} ms, plain {times[kind][3]:.4f} ms ({smi})")
    # the kernels line gives the local calls' shape, where most launches fall
    res_ms, res_plain_ms, bwd_ms, bwd_plain_ms = times["local"]
    print(f"[phase 3b/3e] {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        phase_6a(work)
        _, g_errs = phase_6b(work, cams, dev, smi)
    err_res, err_bwd = max(err_res, g_errs[0]), max(err_bwd, g_errs[1])
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    src = "rtgslam_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "blend_fwd", "route": "cuda", "source": src + "blend_fwd.cu",
         "replaces": "rtgslam_tpu/ops/rasterize/pallas_blend.py:60",
         "launches": launches["blend_fwd"],
         "max_abs_err": max(err_rand, err_real), "ms": k1_ms,
         "plain_ms": plain_ms},
        {"name": "blend_fwd_residual", "route": "cuda",
         "source": src + "blend_fwd.cu",
         "replaces": "rtgslam_tpu/ops/rasterize/pallas_blend.py:60",
         "launches": launches["blend_fwd_residual"], "max_abs_err": err_res,
         "ms": res_ms, "plain_ms": res_plain_ms},
        {"name": "blend_fwd_transmission", "route": "cuda",
         "source": src + "blend_fwd.cu",
         "replaces": "rtgslam_tpu/ops/rasterize/pallas_blend.py:60",
         "launches": launches["blend_fwd_transmission"],
         "max_abs_err": err_trans, "ms": trans_ms,
         "plain_ms": trans_plain_ms},
        {"name": "blend_bwd", "route": "cuda", "source": src + "blend_bwd.cu",
         "replaces": "rtgslam_tpu/ops/rasterize/pallas_blend.py:180",
         "launches": launches["blend_bwd"], "max_abs_err": err_bwd,
         "ms": bwd_ms, "plain_ms": bwd_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
