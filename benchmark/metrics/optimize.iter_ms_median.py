"""Median host milliseconds of one gradient iteration (render, loss,
gradient, Adam, confidence): the port's span ``optimize.iter`` over every
iteration of the first session's frames before the profiled slice.  The
loop holds no host wait, so the span is the iteration's enqueue, which the
device keeps up with while the loop is host-bound."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import spans  # noqa: E402


def read(run):
    found = spans(run, "map.frame")
    if found is None or "optimize.iter" not in found:
        return None
    return found["optimize.iter"]["median_ms"]
