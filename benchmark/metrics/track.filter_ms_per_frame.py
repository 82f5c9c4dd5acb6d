"""Milliseconds of the tracker's bilateral depth filter per tracked frame:
the port's span ``track.filter`` (the filter call of ``preprocess_frame``,
host time: the launch or the plain loop's enqueue), over the first
session's frames before the profiled slice.  None where the program has no
``track.filter`` span."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import ms_per_frame  # noqa: E402


def read(run):
    return ms_per_frame(run, "track.frame", "track.filter")
