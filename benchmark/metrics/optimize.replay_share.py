"""Share of the compact passes' gradient iterations that replayed their
stages as CUDA graphs: 100 x calls of the port's span ``optimize.replay``
over the iterations of the windowed passes (``map.local_optimize`` and
``map.global_optimize`` calls, ``gaussian_update_iter`` iterations each),
over the first session's frames before the profiled slice.  A pass's
first iteration runs eager and its second captures, then replays.  None
where the program has never captured (no ``optimize.capture`` span)."""
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
    iters = passes * run["iters_per_pass"]
    if not iters:
        return None
    return 100.0 * found.get("optimize.replay", {}).get("count", 0) / iters
