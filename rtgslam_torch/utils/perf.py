"""Host-side span timing of the SLAM stages.

Port of ``rtgslam_tpu/utils/perf.py``.  Spans wrap the call sites that
queue device work or fetch a result the host acts on; the report gives
each stage's call count and host wall time.  A span reads the host clock
only and adds no device synchronize, so a stage that only queues kernels
shows its launch cost, and the stage that waits shows the wait.

Enable with ``RTG_PERF=1``; ``report()`` returns a dict, ``dump()`` writes
JSON.  Disabled spans cost one branch.  ``RTG_TRACE=<dir>`` makes
:func:`device_trace` record a ``torch.profiler`` trace of the run there.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = bool(int(os.environ.get("RTG_PERF", "0")))

_stats = defaultdict(list)  # name -> [dt, dt, ...] seconds


@contextmanager
def span(name: str):
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _stats[name].append(time.perf_counter() - t0)


def count(name: str, dt: float = 0.0) -> None:
    if ENABLED:
        _stats[name].append(dt)


def report() -> dict:
    """Per-span count, total seconds, mean and median milliseconds."""
    out = {}
    for k, v in sorted(_stats.items()):
        n = len(v)
        sv = sorted(v)
        med = sv[n // 2] if n % 2 else 0.5 * (sv[n // 2 - 1] + sv[n // 2])
        out[k] = {"count": n, "total_s": round(sum(v), 4),
                  "mean_ms": round(sum(v) / n * 1e3, 3) if n else 0.0,
                  "median_ms": round(med * 1e3, 3) if n else 0.0}
    return out


def reset() -> None:
    _stats.clear()


@contextmanager
def device_trace():
    """With ``RTG_TRACE=<dir>``, record the run with ``torch.profiler``
    (host ops, and the card's kernels where CUDA is available) and write
    its Chrome trace to ``<dir>/trace_<pid>.json``.  No-op when unset."""
    trace_dir = os.environ.get("RTG_TRACE", "")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{os.getpid()}.json"))


def dump(path: str) -> None:
    with open(path, "w") as f:
        json.dump(report(), f, indent=2)
