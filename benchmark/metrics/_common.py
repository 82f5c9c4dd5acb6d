"""Helpers the per-layer readers share (not a metric: no entry names it).

A reader's ``read(run)`` gets the traced run's record: ``frames`` (one dict
per frame of the window: session, index, ok, gradient, track_ms, map_ms),
``sessions``, ``slice`` (the profiled frames of session 0, first and last),
``spans_before`` (the port's host spans' calls and seconds before the
slice), ``iters_per_pass`` and ``trace`` (the slice's digest, ``trace.py``).
It returns a number, or None where it finds nothing to read.  Timings come
from the first session's frames before the slice: the profiler slows the
process after it has run.
"""


import stats  # noqa: E402  (the benchmark's directory is on the path)


def before_slice(run):
    """The frames the profiler did not slow: the first session's before the
    slice (all frames of a run without one)."""
    sl = run.get("slice")
    if not sl:
        return run["frames"]
    return [f for f in run["frames"] if f["session"] == 0 and f["index"] < sl[0]]


def median(values):
    """The median, or None of no values."""
    return stats.median(values) if values else None


def roofline(run, kind):
    """100 x the sampled launches' summed bounds over their summed device
    times, or None without a sample."""
    samples = run.get("trace", {}).get("roofline", {}).get(kind, [])
    spent = sum(s["time_ms"] for s in samples)
    if not samples or spent <= 0:
        return None
    return 100.0 * sum(s["bound_ms"] for s in samples) / spent
