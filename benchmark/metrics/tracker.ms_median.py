"""Median per-frame tracking latency (ms): the frame handed to the tracker
to its pose, read after a device synchronize; the first session's frames
before the profiled slice."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import median, before_slice  # noqa: E402


def read(run):
    return median([f["track_ms"] for f in before_slice(run)])
