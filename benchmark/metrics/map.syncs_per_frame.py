"""Host waits for the stream per mapped frame: the calls of the mapper's,
the optimize loop's and the renderer's wait spans (``map.*``,
``optimize.*`` and ``render.*`` ending in ``_fetch`` or ``upload``: the
counter, overflow, row and size fetches, the camera and constant uploads),
summed over the first session's frames before the profiled slice, over
those frames.  A count that repeats exactly on the same course."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import waits_per_frame  # noqa: E402


def read(run):
    return waits_per_frame(run, "map.frame", ("map.", "optimize.", "render."))
