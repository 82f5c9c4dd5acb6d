"""Host-side span timing of the SLAM stages.

Port of ``rtgslam_tpu/utils/perf.py``.  Spans wrap the call sites that
queue device work or fetch a result the host acts on; the report gives
each stage's call count, host wall time and self time (the time outside
its direct children).  A span reads the host clock only and adds no
device synchronize, so a stage that only queues kernels shows its launch
cost, and the stage that waits shows the wait.

Spans nest per thread: each knows its parent on its own thread's stack, so
the pipelined system's tracker and mapper threads never nest into each
other's spans.  While a ``torch.profiler`` records, each span also opens
the range ``stage:<name>``, so the program's stages appear on the
profiler's timeline beside the device's work.

**Waits.**  A span that wraps a point where the host blocks until the
stream drains ends in ``_fetch`` (device to host) or ``upload`` (host to
device from pageable memory).  Each call of such a span is one wait, even
where it holds several transfers back to back, and its time is the host's
wait (:func:`is_wait`).

Enable with ``RTG_PERF=1``; ``report()`` returns a dict, ``dump()`` writes
JSON.  Disabled spans cost one branch and touch no profiler API.
``RTG_TRACE=<dir>`` makes :func:`device_trace` record a ``torch.profiler``
trace of the run there.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Optional

import torch

ENABLED = bool(int(os.environ.get("RTG_PERF", "0")))
WAIT_SUFFIXES = ("_fetch", "upload")

_stats = defaultdict(list)  # name -> [(seconds, children's seconds), ...]
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open spans
_OFF = nullcontext()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "children_s", "t0", "rng")

    def __init__(self, name: str):
        self.name = name
        self.children_s = 0.0
        self.rng = None

    def __enter__(self):
        _stack().append(self)
        if torch.autograd._profiler_enabled():
            self.rng = torch.profiler.record_function("stage:" + self.name)
            self.rng.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self.t0
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].children_s += dt
        with _lock:
            _stats[self.name].append((dt, self.children_s))
        return False


def span(name: str):
    """Time the block as the span ``name`` (a context manager)."""
    if not ENABLED:
        return _OFF
    return _Span(name)


def mark(name: str) -> None:
    """Record the span ``name`` opened and closed at once: its count
    counts an event."""
    if ENABLED:
        with _Span(name):
            pass


def current() -> Optional[str]:
    """The innermost open span of the calling thread, None outside any."""
    stack = _stack()
    return stack[-1].name if stack else None


def open_spans() -> tuple:
    """The calling thread's open spans, outermost first."""
    return tuple(s.name for s in _stack())


def is_wait(name: str) -> bool:
    """Whether the span ``name`` wraps a host wait for the stream."""
    return name.endswith(WAIT_SUFFIXES)


def report() -> dict:
    """Per-span count, total and self seconds, mean and median
    milliseconds."""
    with _lock:
        items = sorted((k, list(v)) for k, v in _stats.items())
    out = {}
    for k, v in items:
        n = len(v)
        sv = sorted(dt for dt, _ in v)
        total = sum(sv)
        med = sv[n // 2] if n % 2 else 0.5 * (sv[n // 2 - 1] + sv[n // 2])
        out[k] = {"count": n, "total_s": round(total, 4),
                  "self_s": round(total - sum(c for _, c in v), 4),
                  "mean_ms": round(total / n * 1e3, 3),
                  "median_ms": round(med * 1e3, 3)}
    return out


def reset() -> None:
    with _lock:
        _stats.clear()


@contextmanager
def device_trace():
    """With ``RTG_TRACE=<dir>``, record the run with ``torch.profiler``
    (host ops, the spans' ``stage:`` ranges with ``RTG_PERF=1``, and the
    card's kernels where CUDA is available) and write its Chrome trace to
    ``<dir>/trace_<pid>.json``.  No-op when unset."""
    trace_dir = os.environ.get("RTG_TRACE", "")
    if not trace_dir:
        yield
        return
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
