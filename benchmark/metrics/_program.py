"""Helpers the readers of the port's own spans share (not a metric: no
entry names it).

The port's tracer (``rtgslam_torch/utils/perf.py``, on in traced runs)
reports each span's ``count``, ``total_s``, ``self_s``, ``mean_ms`` and
``median_ms``; ``run["spans_before"]`` holds that report at the start of
the profiled slice, so it covers the first session's frames before it.
A span whose name ends in ``_fetch`` or ``upload`` wraps a point where the
host waits for the stream: each of its calls is one wait.

The readers return None where the program has no such spans (a program
without ``track.frame`` and ``map.frame``, the parents of every span they
read, or a traced run without a device timeline, where a wait waits for no
device and the spans time the CPU's kernels).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import before_slice  # noqa: E402

WAIT_SUFFIXES = ("_fetch", "upload")


def spans(run, parent):
    """The span report before the slice, or None without the device or
    without the span ``parent``."""
    found = run.get("spans_before", {})
    if not run.get("trace", {}).get("busy_s") or parent not in found:
        return None
    return found


def waits_per_frame(run, parent, prefixes):
    """Calls of the wait spans named ``<prefix>*`` per frame before the
    slice."""
    found = spans(run, parent)
    frames = len(before_slice(run))
    if found is None or not frames:
        return None
    return sum(v["count"] for k, v in found.items()
               if k.startswith(prefixes) and k.endswith(WAIT_SUFFIXES)) / frames


def ms_per_frame(run, parent, name):
    """Milliseconds in the span ``name`` per frame before the slice."""
    found = spans(run, parent)
    frames = len(before_slice(run))
    if found is None or name not in found or not frames:
        return None
    return 1e3 * found[name]["total_s"] / frames
