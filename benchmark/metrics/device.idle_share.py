"""The device's idle share of the profiled slice (%): 1 - (union of the
device's kernel, copy and set intervals) / the slice's wall time."""


def read(run):
    t = run.get("trace", {})
    if not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
