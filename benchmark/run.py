#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 benchmark/run.py --workload replica_680x1200.orbit --seed 7 \\
        --seconds 51 --trace 0

From the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the port's package ``rtgslam_torch``, on a machine with the CUDA
devices the cell asks for.  Set-up makes the cell's frames on the card
(the traffic file fixes them, so every run does the same work), loads the
kernels (built into the checkout's ``build/`` on the first run only) and
runs one discarded warm session; the window then runs whole SLAM sessions
back to back until ``--seconds`` have passed.  After the window the first
session's outputs are compared with the plain reference
(``benchmark/reference/``); the seed draws which gradient iteration of it
the comparison keeps (``correctness.draw_sample``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (frames handed to the system in the window), ``failed``
(frames the tracker's fail gate rejected), ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, last, ``checks``:
each number compared beside its limit.  With ``--trace 1`` a profiled slice
of the first session adds ``breakdown`` and the device's busy and window
seconds.  Exits 2 without the devices the cell asks for, 3 when a module
of JAX or of the JAX package was loaded, and with a ``port.PortChanged``
error when a name of the port that the harness hooks is gone or no longer
called.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# one process with one compute thread: the loop is host-bound, and idle
# worker threads spinning on a shared host only add noise
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# no module of JAX, of Flax or of the JAX package may be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "rtgslam_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def build_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")


def main(argv=None, device=None, root=ROOT, controls=()) -> int:
    """Run the cell ``argv`` names.  ``device`` None needs CUDA; the tests
    pass "cpu" to drive a run without a card and ``root`` to run a copy of
    the benchmark.  ``controls`` (``control.py``) also prints the readings
    with each named control in the program's place ("none": the program's
    own), each with its verdict against the cell's limits, as ``[control]``
    lines on standard error."""
    opts = parse(argv)
    for path in (HERE, root):
        if path not in sys.path:
            sys.path.insert(0, path)
    import manifest

    bench = manifest.load(root)
    cell = manifest.cell(bench, opts.workload)
    cfg = manifest.config(bench, root, cell["config"])
    mix = manifest.traffic(root, cell["traffic"])

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            sys.stderr.write(f"[benchmark] {opts.workload} needs {cell['chips']} "
                             f"CUDA device(s); torch sees "
                             f"{torch.cuda.device_count()}\n")
            return 2
        device = "cuda:0"
    build_dirs(root)
    torch.set_num_threads(1)

    import correctness
    import port
    import scene
    import session
    import stats
    import trace
    from rtgslam_torch.models import optimize
    from rtgslam_torch.ops.rasterize import blend
    from rtgslam_torch.utils import perf

    port.check()
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    t_ready = time.perf_counter()
    H, W = cfg["frame_size"]
    n_frames = int(cfg["args"]["frame_num"])
    args = session.make_args(cfg)
    seq = scene.make_sequence(mix["sensor"], mix["motion"], H, W, n_frames, dev)
    t_frames = time.perf_counter()
    session.warm_up(args, seq, dev)
    session.sync(dev)
    setup_s = time.perf_counter() - T_START
    sys.stderr.write(f"[benchmark] set-up {setup_s:.2f} s: imports and device "
                     f"{t_ready - T_START:.2f} s, frames {t_frames - t_ready:.2f} s, "
                     f"warm session {time.perf_counter() - t_frames:.2f} s\n")

    grad = session.gradient_frames(args, n_frames)
    span = trace.slice_frames(grad) if opts.trace else None
    sl = trace.Slice(blend) if span else None
    capture = correctness.Capture(blend, optimize, correctness.draw_sample(
        opts.seed, grad, int(args.gaussian_update_iter)))
    run_hooks = RunHooks(capture, sl, span)
    if opts.trace:
        perf.ENABLED = True
        perf.reset()
    # what set-up made stays: the collector's full passes skip it
    gc.collect()
    gc.freeze()
    with capture:
        window = session.run_window(args, seq, dev, opts.seconds, run_hooks)
    if sl is not None and sl.running:   # the window closed inside the slice
        sl.stop()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    spans_before = run_hooks.spans_at.get("start", perf.report()) if opts.trace else {}
    perf.ENABLED = False
    gc.unfreeze()

    frames, sessions = window["frames"], window["sessions"]
    first = sessions[0]
    failed = sum(not f["ok"] for f in frames)
    overflow = max(s["overflow"] for s in sessions)
    metrics = {}
    if opts.trace:
        run = {"frames": frames, "sessions": sessions,
               "spans_before": spans_before,
               "slice": span, "trace": trace.digest(sl) if sl and sl.prof
               else {}, "iters_per_pass": int(args.gaussian_update_iter)}
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for name, read in manifest.readers(bench, root, opts.workload).items():
            value = read(run)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        e2e = {"fps": stats.fps(len(frames), window["window_s"]),
               "track_ms_p90": stats.percentile(
                   [f["track_ms"] for f in frames], 90),
               "setup_s": setup_s, "psnr_db": capture.psnr_db,
               "ate_cm": stats.ate_rmse_cm(first["poses"], seq["poses"])}
        for m in manifest.end_to_end(bench, opts.workload):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the program's state is freed before the reference runs
    paused_s = run_hooks.paused_s
    del window, run_hooks
    t_ref = time.perf_counter()
    checks = capture.judge(root, opts.workload, cfg, seq, first, overflow, dev)
    sys.stderr.write(f"[benchmark] {len(sessions)} sessions, {len(frames)} "
                     f"frames, keyframes {first['keyframes']}, sample "
                     f"{capture.sample}; reference "
                     f"{time.perf_counter() - t_ref:.2f} s\n")
    before = [f["track_ms"] for f in frames if span and f["session"] == 0
              and f["index"] < span[0]]
    after = [f["track_ms"] for f in frames if f["session"] > 0]
    if before and after:
        sys.stderr.write(f"[benchmark] tracking median {stats.median(before):.2f} ms "
                         f"before the slice, {stats.median(after):.2f} after; "
                         f"profiler start and stop {paused_s:.2f} s\n")
    correct = all(c["pass"] for c in checks.values())
    for name in controls:
        readings = (capture.last_readings if name == "none" else
                    capture.readings(cfg, seq, first, overflow, dev, name))
        judged = correctness.verdict(
            readings, correctness.load_limits(root, opts.workload))
        sys.stderr.write("[control] " + json.dumps(
            {"control": name, "seed": opts.seed,
             "correct": all(c["pass"] for c in judged.values()),
             "failed": sorted(k for k, c in judged.items() if not c["pass"]),
             "readings": readings, "program": capture.last_readings}) + "\n")

    found = forbidden_modules()
    if found:
        sys.stderr.write(f"[benchmark] loaded modules of JAX or of the JAX "
                         f"package: {found}\n")
        return 3
    result = {"correct": bool(correct), "attempted": len(frames),
              "failed": int(failed), "metrics": metrics,
              "device": device_line(dev, cell["chips"], memory_peak)}
    if opts.trace and sl is not None and sl.prof is not None:
        t = run["trace"]
        if t.get("busy_s"):
            result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
            result["breakdown"] = {"device_ops": t["device_ops"],
                                   "idle_gaps": t["idle_gaps"]}
    result["checks"] = checks
    sys.stdout.flush()
    for name, c in checks.items():
        sys.stderr.write(f"[check] {name} {c['value']!r} limit {c['limit']} "
                         f"({c['rule']}) {'pass' if c['pass'] else 'FAIL'}\n")
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False, default=_finite), flush=True)
    return 0


def _finite(x):
    return float(x)


def device_line(dev, chips: int, memory_peak: int):
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": int(memory_peak)}


class RunHooks:
    """The window's hooks: the correctness capture on the first session,
    and, in a traced run, the profiled slice of the first session's frames
    with the host spans read apart from it."""

    def __init__(self, capture, sl, span):
        self.capture, self.sl, self.span = capture, sl, span
        self.spans_at = {}
        # seconds the profiler took to start and stop, which the window's
        # deadline does not count
        self.paused_s = 0.0

    def _in_slice(self, s, i):
        return self.sl is not None and s == 0 and self.span[0] <= i <= self.span[1]

    def session_start(self, s, tracker, mapper):
        self.capture.session_start(s, tracker, mapper)

    def frame_start(self, s, i):
        self.capture.frame_start(s, i)
        if self._in_slice(s, i) and i == self.span[0]:
            from rtgslam_torch.utils import perf

            t0 = time.perf_counter()
            self.spans_at["start"] = perf.report()
            self.sl.start()
            self.paused_s += time.perf_counter() - t0

    def frame_end(self, s, i):
        self.capture.frame_end(s, i)
        if self._in_slice(s, i):
            self.sl.frames += 1
            if i == self.span[1]:
                t0 = time.perf_counter()
                self.sl.stop()
                self.paused_s += time.perf_counter() - t0

    def stage(self, name):
        return self.sl.stage(name) if self.sl is not None else contextlib.nullcontext()

    def session_end(self, s, info):
        self.capture.session_end(s, info)


if __name__ == "__main__":
    sys.exit(main())
