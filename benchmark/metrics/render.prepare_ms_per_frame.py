"""Milliseconds of render preparation per mapped frame: the port's span
``render.prepare`` (projection, depth sort, binning and shading before a
blend: ``api.py::_sorted_pass``, ``render_transmission`` and
``optimize._frozen_bins``), every render of the first session's frames
before the profiled slice, over those frames.  Host time: the enqueue, and
the waits inside."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import ms_per_frame  # noqa: E402


def read(run):
    return ms_per_frame(run, "map.frame", "render.prepare")
