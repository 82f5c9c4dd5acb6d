"""Kernel launches per frame in the profiled slice: the device's kernels
(copies and sets left out) over the slice's frames.  A count that repeats
exactly on the same course."""


def read(run):
    t = run.get("trace", {})
    if not t.get("frames") or not t.get("kernels"):
        return None
    return t["kernels"] / t["frames"]
