"""Share of the tracker's ICP solves that replayed a captured CUDA graph:
100 x calls of the port's span ``track.solve_replay`` over calls of
``track.solve`` (every ``icp_solve_all_levels``: the tracker's solve and
the loop closer's verifying ones), over the first session's frames before
the profiled slice.  A solve that captured, or ran eager, is not a
replay.  None where the program has no ``track.solve`` span."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import spans  # noqa: E402


def read(run):
    found = spans(run, "track.frame")
    if found is None or not found.get("track.solve", {}).get("count"):
        return None
    replays = found.get("track.solve_replay", {}).get("count", 0)
    return 100.0 * replays / found["track.solve"]["count"]
