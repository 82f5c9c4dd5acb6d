"""Milliseconds of a gradient pass's preparation: the port's span
``optimize.prepare`` (the compact path's ``optimize_prepare`` and
``compact_problem`` with the reduce's row index; the masks of a pass over
full renders) over the first session's frames before the profiled slice,
over the windowed passes there (``map.local_optimize`` and
``map.global_optimize`` calls)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import spans  # noqa: E402


def read(run):
    found = spans(run, "map.frame")
    if found is None or "optimize.prepare" not in found:
        return None
    passes = sum(found[k]["count"] for k in
                 ("map.local_optimize", "map.global_optimize") if k in found)
    return 1e3 * found["optimize.prepare"]["total_s"] / passes if passes else None
