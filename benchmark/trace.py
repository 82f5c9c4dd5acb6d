"""The traced run's instruments: a ``torch.profiler`` slice of frames, a
sample of the blend launches inside it, and the digest the per-layer
readers take their numbers from.

The profiler covers only the slice (a fixed span at the end of the first
session's frames that holds two gradient passes); its events stay in memory and no
trace file is written.  Every K1 (``blend_fwd_kernel``) and K2
(``blend_bwd_kernel``) launch in the slice is counted through the port's
``blend._launch``, so the profiler's kernels of each name line up with the
launches in order; every ``SAMPLE_EVERY``-th residual-mode K1 launch and
K2 launch keeps its inputs, whose work ``work.py`` counts after the run.
Where the launches counted and the profile's kernels of a name do not pair,
:func:`digest` raises ``port.PortChanged`` rather than leave a roofline
empty.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

import port
import stats
import work

SAMPLE_EVERY = 5
K1_NAME, K2_NAME = "blend_fwd_kernel", "blend_bwd_kernel"
REDUCE_NAME = "blend_bwd_reduce_kernel"


class LaunchSampler:
    """Wraps the port's blend entry points while the slice runs: counts K1
    and K2 launches and keeps the inputs of every ``SAMPLE_EVERY``-th
    residual-mode K1 and K2 launch (device clones)."""

    def __init__(self, blend):
        self.blend = blend
        self.k1 = 0
        self.k2 = 0
        self.samples: List[Dict] = []
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        patch = lambda name, make: self._stack.enter_context(
            port.patch(self.blend, name, make))
        patch("_launch", self._count)
        patch("blend_tiles", self._sample_tiles)
        patch("blend_bwd_partials", self._sample_partials)
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False

    def _count(self, launch):
        def counted_launch(fn, kernel, *args):
            launch(fn, kernel, *args)
            if kernel.startswith("blend_fwd") or kernel == "blend_transmission":
                self.k1 += 1
            elif kernel == "blend_bwd":
                self.k2 += 1
        return counted_launch

    def _sample_tiles(self, tiles):
        def sampled_tiles(feat, order, lists, counts, origins, *rest, **kw):
            seq = self.k1
            out = tiles(feat, order, lists, counts, origins, *rest, **kw)
            residual = kw.get("residuals", rest[2] if len(rest) > 2 else False)
            if residual and self.k1 > seq and seq % SAMPLE_EVERY == 0:
                self.samples.append({
                    "kind": "residual", "seq": seq, "feat": feat.clone(),
                    "lists": lists.clone(), "counts": counts.clone(),
                    "origins": origins.clone(), "done": out[2].clone()})
            return out
        return sampled_tiles

    def _sample_partials(self, partials):
        def sampled_partials(feat, order, lists, counts, origins, entry, done,
                             *rest):
            seq = self.k2
            out = partials(feat, order, lists, counts, origins, entry, done,
                           *rest)
            if self.k2 > seq and seq % SAMPLE_EVERY == 0:
                self.samples.append({
                    "kind": "bwd", "seq": seq, "feat": feat.clone(),
                    "lists": lists.clone(), "counts": counts.clone(),
                    "origins": origins.clone(), "done": done.clone()})
            return out
        return sampled_partials


class Slice:
    """The profiled slice: ``start`` before its first frame, ``stop`` after
    its last; user annotations name the stages inside it."""

    def __init__(self, blend):
        self.prof = None
        self.sampler = LaunchSampler(blend)
        self.frames = 0
        self.running = False
        self._range = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.sampler.__enter__()
        self._range = record_function("bench.slice")
        self._range.__enter__()
        self.running = True

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.sampler.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.running = False

    def stage(self, name: str):
        if self.prof is None or self._range is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("stage:" + name)


def _events(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on the device, start, end) in seconds, for every event of the
    profile."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = "cuda" in str(ev.device_type()).lower()
        if hasattr(ev, "start_ns"):
            s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
        else:
            s, d = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
        out.append((ev.name(), dev, s, s + d))
    return out


def digest(sl: Slice) -> Dict:
    """What the readers need from the slice: the device's busy and window
    seconds, the kernel count, the longest device operations and idle gaps,
    and the sampled launches' bounds beside their device times."""
    events = _events(sl.prof)
    window = [e for e in events if e[0] == "bench.slice" and not e[1]]
    if not window:
        return {"error": "no bench.slice annotation in the profile"}
    w0, w1 = window[0][2], window[0][3]
    # the device's own work: the annotations' mirrors on the device's
    # timeline are not work
    device = [e for e in events if e[1] and e[3] > w0 and e[2] < w1
              and e[0] != "bench.slice" and not e[0].startswith("stage:")]
    kernels = [e for e in device
               if not e[0].startswith(("Memcpy", "Memset", "Memory"))]
    busy = stats.union_length((max(s, w0), min(e, w1)) for _, _, s, e in device)
    by_name: Dict[str, float] = {}
    for name, _, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    host = sorted((e for e in events if not e[1] and e[2] < w1 and e[3] > w0
                   and e[0] != "bench.slice"), key=lambda e: e[2])
    idle = sorted(stats.gaps(((s, e) for _, _, s, e in device), w0, w1),
                  key=lambda g: g[0] - g[1])[:10]
    named_gaps = [[_host_activity(host, (g0 + g1) / 2), g1 - g0]
                  for g0, g1 in idle]

    k1 = sorted((e for e in kernels if K1_NAME in e[0]), key=lambda e: e[2])
    k2 = sorted((e for e in kernels if K2_NAME in e[0] and REDUCE_NAME not in e[0]),
                key=lambda e: e[2])
    out = {"busy_s": busy, "window_s": w1 - w0, "kernels": len(kernels),
           "frames": sl.frames, "device_ops": [[n, t] for n, t in top_ops],
           "idle_gaps": named_gaps, "k1_launches": sl.sampler.k1,
           "k2_launches": sl.sampler.k2, "k1_events": len(k1),
           "k2_events": len(k2), "roofline": {"residual": [], "bwd": []}}
    timed = {"residual": k1, "bwd": k2}
    counted = {"residual": sl.sampler.k1, "bwd": sl.sampler.k2}
    if torch.cuda.is_available():
        for kind, evs in timed.items():
            if len(evs) != counted[kind] or not evs:
                raise port.PortChanged(
                    f"{kind}: {counted[kind]} launches counted through "
                    f"blend._launch, {len(evs)} kernels named "
                    f"{K1_NAME if kind == 'residual' else K2_NAME} in the "
                    f"profiled slice; the roofline cannot pair them")
    for smp in sl.sampler.samples:
        _, _, s, e = timed[smp["kind"]][smp["seq"]]
        w = work.live_work(smp["feat"], smp["lists"], smp["counts"],
                           smp["done"], smp["origins"])
        T, Kt = smp["lists"].shape
        ms, by = work.work_bound(smp["kind"], w, T, Kt // min(work.CHUNK, Kt))
        out["roofline"][smp["kind"]].append(
            {"bound_ms": ms, "bound_by": by, "time_ms": (e - s) * 1e3,
             "pairs": w["pairs"]})
    sl.sampler.samples.clear()
    return out


def _host_activity(host: List[Tuple], t: float) -> str:
    """The stage annotation and the innermost host operation running at
    ``t``."""
    stage, op, op_start = "none", "host code outside any recorded op", None
    for name, _, s, e in host:
        if s > t:
            break
        if e < t:
            continue
        if name.startswith("stage:"):
            stage = name[len("stage:"):]
        elif op_start is None or s >= op_start:
            op, op_start = name, s
    return f"{stage}: {op}"


def slice_frames(gradient: List[int]) -> Optional[Tuple[int, int]]:
    """The profiled frames: the session's last two gradient frames and the
    frames between them.  Last, because a process runs slower once the
    profiler has stopped (on the card: tracking 54 ms a frame before a slice,
    83 after), so the per-layer timings are read from the frames before it."""
    if len(gradient) < 3:
        return None
    return gradient[-2], gradient[-1]
