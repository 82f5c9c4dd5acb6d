"""Frames per second of the first session before the profiled slice: its
frames there over the wall seconds from the first frame handed to the
tracker to the last one mapped, the host's work between frames included.
The window's ``fps`` read where the profiler has not yet run, for a cell
whose ``fps`` the host spreads too widely to hold end to end."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import before_slice  # noqa: E402


def read(run):
    frames = before_slice(run)
    if not frames:
        return None
    first = frames[0]
    start = first["end"] - (first["track_ms"] + first["map_ms"]) / 1e3
    seconds = frames[-1]["end"] - start
    return len(frames) / seconds if seconds > 0 else None
