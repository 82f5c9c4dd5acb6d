"""Median mapping time (ms) of the frames without a gradient pass: spawn,
lifecycle, the model render and its hand-back to the tracker, to a device
synchronize; every such frame of the
first session before the profiled slice."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import median, before_slice  # noqa: E402


def read(run):
    return median([f["map_ms"] for f in before_slice(run) if not f["gradient"]])
