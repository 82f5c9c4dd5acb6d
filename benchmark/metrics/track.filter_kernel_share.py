"""Share of the tracker's bilateral depth filters that ran the hand-written
kernel: 100 x calls of the port's span ``track.filter_kernel`` (one
launch of ``csrc/bilateral.cu``) over calls of ``track.filter`` (every
filter call of ``preprocess_frame``), over the first session's frames
before the profiled slice.  None where the program has no ``track.filter``
span."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import spans  # noqa: E402


def read(run):
    found = spans(run, "track.frame")
    if found is None or not found.get("track.filter", {}).get("count"):
        return None
    kernels = found.get("track.filter_kernel", {}).get("count", 0)
    return 100.0 * kernels / found["track.filter"]["count"]
