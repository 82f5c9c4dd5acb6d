"""Milliseconds of the loop closer per tracked frame: the port's span
``track.loop_check`` (``LoopCloser.observe`` every ``loop_check_every``-th
frame, and ``relocalize`` after a hard failure; the depth fetch and the
verifying ICP solve inside), over the first session's frames before the
profiled slice."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import ms_per_frame  # noqa: E402


def read(run):
    return ms_per_frame(run, "track.frame", "track.loop_check")
