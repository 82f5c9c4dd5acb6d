"""Host waits for the stream per tracked frame: the calls of the tracker's
wait spans (``track.*_fetch``, ``track.*upload``: the pose and solve
fetches, the depth fetch of a loop check, the pageable uploads), summed
over the first session's frames before the profiled slice, over those
frames.  A count that repeats exactly on the same course."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import waits_per_frame  # noqa: E402


def read(run):
    return waits_per_frame(run, "track.frame", ("track.",))
