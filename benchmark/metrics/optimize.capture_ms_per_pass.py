"""Milliseconds a windowed gradient pass spends capturing its stages as
CUDA graphs: the port's span ``optimize.capture`` over the first
session's frames before the profiled slice, over the windowed passes there
(``map.local_optimize`` and ``map.global_optimize`` calls).  None where
the program has never captured (no ``optimize.capture`` span)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import spans  # noqa: E402


def read(run):
    found = spans(run, "map.frame")
    if found is None or "optimize.capture" not in found:
        return None
    passes = sum(found[k]["count"] for k in
                 ("map.local_optimize", "map.global_optimize") if k in found)
    return 1e3 * found["optimize.capture"]["total_s"] / passes if passes else None
