"""Milliseconds per gradient iteration of the windowed passes: the port's
host spans ``map.local_optimize`` and ``map.global_optimize`` (each pass
runs ``gaussian_update_iter`` iterations), summed over the first
session's frames before the profiled slice, over their iterations.  The loop is host-bound, so the spans lag the
device by a few kernels at most."""


def read(run):
    spans = run.get("spans_before", {})
    calls, seconds = 0, 0.0
    for name in ("map.local_optimize", "map.global_optimize"):
        if name in spans:
            calls += spans[name]["count"]
            seconds += spans[name]["total_s"]
    iters = calls * run["iters_per_pass"]
    return 1e3 * seconds / iters if iters > 0 else None
