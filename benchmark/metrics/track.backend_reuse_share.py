"""Share of the pose backend's image calls that allocated no frame-sized
buffer: 100 x calls of the port's marker span ``track.backend_reused``
(recorded after a backend call whose ``last_frame_reused`` reads true) over
calls of ``track.backend``, over the first session's frames before the
profiled slice.  None where the program has no ``track.backend_reused``
span."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import spans  # noqa: E402


def read(run):
    found = spans(run, "track.frame")
    if (found is None or "track.backend_reused" not in found
            or not found.get("track.backend", {}).get("count")):
        return None
    return (100.0 * found["track.backend_reused"]["count"]
            / found["track.backend"]["count"])
