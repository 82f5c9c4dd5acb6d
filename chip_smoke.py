#!/usr/bin/env python3
"""Drive the PyTorch port (``rtgslam_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and nothing falls back to the CPU):
  1. require a CUDA device; print the card's name and power limit;
  2. build kernel K1 (csrc/blend_fwd.cu) from the sources, print the seconds;
  3. hold K1 against its plain PyTorch twin on random tiles, then (after
     phase 5) on the real tile lists of a 680x1200 frame, with both times;
  4. run the slice at 170x300 x 12 frames and compare with the JAX-on-CPU
     reference in tests/data/;
  5. run the slice at 680x1200 x 12 frames (map capacity 2^19) with the
     launch counts reset just before: overflow 0, finite metrics, ATE <= 1 cm,
     K1 launched at least once per render.
The line before the last is the kernel report, the last the device line.
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REF_170 = os.path.join(REPO, "tests", "data", "slice_170x300_jax_cpu.json")
FRAMES = 12
# K1 vs the plain twin: sequential vs log-space transmittance, rounding only
BLEND_ATOL = 1e-5
# index maps may differ only where the plain twin and K1 round a tie
# differently; such pixels must stay this rare
TIE_FRACTION = 1e-3
# phase 4 against the JAX reference: the port replays JAX's spawn priority
# stream (utils/threefry.py), so both sample the same pixels; what is left
# is float rounding (GPU vs CPU, sequential vs log-space transmittance),
# which can flip a threshold test at a few pixels
REF_TOL = {"ate_cm": 0.05, "psnr": 0.2, "depth_l1_cm": 0.1, "gaussians_rel": 0.01}


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


def check_slice(res, label):
    ev = res["eval"]
    vals = [res["ate_cm"], ev["psnr"], ev["depth_l1_cm"]]
    if not all(math.isfinite(v) for v in vals):
        fail(f"{label}: non-finite metrics {vals}")
    if res["max_overflow"] != 0:
        fail(f"{label}: bin overflow {res['max_overflow']}")
    track = sorted(res["track_ms"][1:])[len(res["track_ms"][1:]) // 2]
    mapping = sorted(res["map_ms"][1:])[len(res["map_ms"][1:]) // 2]
    print(f"[{label}] ATE {res['ate_cm']:.4f} cm  PSNR {ev['psnr']:.3f}  "
          f"depth L1 {ev['depth_l1_cm']:.4f} cm  gaussians "
          f"{res['n_stable'] + res['n_unstable']}  overflow "
          f"{res['max_overflow']}  median tracking {track:.2f} ms  "
          f"median mapping {mapping:.2f} ms per frame (frames 1..{FRAMES - 1})")
    return track, mapping


def main():
    import torch

    # ---- phase 1: the card ---------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from rtgslam_torch import setup_device
    from rtgslam_torch.data.synthetic import make_cameras
    from rtgslam_torch.models.gaussian_map import alive_mask, render_inputs
    from rtgslam_torch.ops.rasterize import api, binning, blend
    from rtgslam_torch.slam.run import make_args, run_sequence
    from rtgslam_torch.utils import cuda_build, threefry

    dev = setup_device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[phase 1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- phase 2: build K1 ---------------------------------------------
    t0 = time.perf_counter()
    blend._kernel_lib()
    info = cuda_build.build_info["blend_fwd"]
    print(f"[phase 2] built blend_fwd in {info['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")
    print(info["ptxas"].strip())

    # ---- phase 3a: K1 vs plain on random tiles ---------------------------
    feat, order, lists, counts, origins = random_tiles(dev)
    out = blend.blend_tiles(feat, order, lists, counts, origins, 0.6, 1e-4)
    ref = blend.blend_tiles_reference(feat, order, lists, counts, origins, 0.6, 1e-4)
    torch.cuda.synchronize()
    err_rand, ct, dt = compare_blend(out, ref, feat, order, origins, 0.6)
    print(f"[phase 3a] random tiles {tuple(lists.shape)}: max abs err "
          f"{err_rand:.3g}, index near-ties color {ct} depth {dt}")

    # ---- phase 4: slice at 170x300 vs the JAX reference ------------------
    with open(REF_170) as f:
        jref = json.load(f)
    res = run_sequence(make_args(170, 300), make_cameras(FRAMES, 170, 300), dev,
                       threefry.jax_priorities())
    check_slice(res, "phase 4 170x300")
    got = {"ate_cm": res["ate_cm"], "psnr": res["eval"]["psnr"],
           "depth_l1_cm": res["eval"]["depth_l1_cm"]}
    for k, v in got.items():
        if not abs(v - jref[k]) <= REF_TOL[k]:
            fail(f"phase 4: {k} {v:.4f} vs JAX {jref[k]:.4f} (tol {REF_TOL[k]})")
    n_port = res["n_stable"] + res["n_unstable"]
    n_jax = jref["n_stable"] + jref["n_unstable"]
    if not abs(n_port - n_jax) <= REF_TOL["gaussians_rel"] * n_jax:
        fail(f"phase 4: {n_port} gaussians vs JAX {n_jax}")
    if res["max_overflow"] != jref["max_overflow"]:
        fail(f"phase 4: overflow {res['max_overflow']} vs JAX {jref['max_overflow']}")
    print(f"[phase 4] matches JAX-CPU reference: ATE {jref['ate_cm']:.4f}, PSNR "
          f"{jref['psnr']:.3f}, depth L1 {jref['depth_l1_cm']:.4f}, gaussians "
          f"{n_jax}, overflow {jref['max_overflow']} (tolerances {REF_TOL})")

    # ---- phase 5: the main path at 680x1200 -------------------------------
    args = make_args(680, 1200)
    if args.map_capacity != 1 << 19:
        fail(f"map capacity {args.map_capacity} != 2^19")
    cams = make_cameras(FRAMES, 680, 1200)
    blend.blend_tiles.launches = 0
    res = run_sequence(args, cams, dev)
    launches = blend.blend_tiles.launches
    track_ms, map_ms = check_slice(res, "phase 5 680x1200")
    renders = 2 * FRAMES   # lifecycle render per frame, spawn render from frame 1, eval
    if launches < renders:
        fail(f"phase 5: K1 launched {launches} times for {renders} renders")
    if not res["ate_cm"] <= 1.0:
        fail(f"phase 5: ATE {res['ate_cm']:.4f} cm > 1.0 cm")
    print(f"[phase 5] K1 launches {launches} for {renders} renders; "
          f"median tracking {track_ms:.2f} ms, mapping {map_ms:.2f} ms per frame")

    # ---- phase 3b: K1 vs plain on the real tile lists of that frame -------
    mapper = res["mapper"]
    camera = cams[-1].device_dict(dev)
    gauss = render_inputs(mapper.state, alive_mask(mapper.state))
    feat, bins = api._sorted_pass(gauss, camera["w2c"], camera["K"],
                                  camera["campos"], mapper.settings)
    st = mapper.settings
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

    print(json.dumps({"kernels": [{
        "name": "blend_fwd", "route": "cuda",
        "source": "rtgslam_torch/csrc/blend_fwd.cu",
        "replaces": "rtgslam_tpu/ops/rasterize/pallas_blend.py:60",
        "launches": launches, "max_abs_err": max(err_rand, err_real),
        "ms": k1_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
