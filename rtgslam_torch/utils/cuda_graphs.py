"""The one place that captures a CUDA graph, for the tracker's ICP solve
(``ops/icp.py``) and a compact optimize pass (``models/optimize.py``)."""

import threading

import torch


def capture(steps, side, *, pool=None, warmup=False):
    """Each of ``steps`` (callables that launch on the current stream and
    keep their outputs) as a CUDA graph, in order, in ``pool`` (None: a
    pool each), on the stream ``side``, which waits for the caller's stream
    and is waited for after.  ``warmup`` runs a step eager first (torch's
    recipe: there that stream's cuBLAS and cuSOLVER handles and workspaces
    are made).  Thread-local: the pipelined system's other thread may
    launch and wait meanwhile.  Until ``capture_end`` the default CUDA
    generator is the capture's: the mapper draws from its own."""
    caller = torch.cuda.current_stream(side.device)
    side.wait_stream(caller)
    graphs = []
    with torch.cuda.stream(side):
        for step in steps:
            if warmup:
                step()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                step()
            finally:
                graph.capture_end()
            graphs.append(graph)
    caller.wait_stream(side)
    return graphs


_local = threading.local()   # .pools: device -> (CUDAGraph, Stream)


def thread_pool(device):
    """The calling thread's graph memory pool and capture stream on
    ``device``, kept while the thread lives, so that each pass reuses the
    memory of the last pass's graphs.  A pool lives while a graph captured
    into it does: a one-op graph that is never replayed holds it (torch's
    allocators assert when a capture names a pool with no live graph, a
    ``MemPool``'s included)."""
    pools = _local.__dict__.setdefault("pools", {})
    if device not in pools:
        side = torch.cuda.Stream(device)
        pools[device] = capture([lambda: torch.zeros((1,), device=device)],
                                side)[0], side
    holder, side = pools[device]
    return holder.pool(), side


def replay_key(tensors, settings):
    """Shapes, dtypes, settings and where a graph replays (device, thread,
    stream: its static inputs serve one caller at a time)."""
    dev = tensors[0].device
    return (dev, threading.get_ident(),
            torch.cuda.current_stream(dev).cuda_stream,
            tuple((t.shape, t.dtype) for t in tensors), settings)


class GraphCache(dict):
    """Replays by key, kept for the process's life, at most ``bound``."""

    def __init__(self, bound):
        self.bound, self._lock = bound, threading.Lock()

    def add(self, key, make):
        """The replay of ``key``, made by ``make()`` under the lock if new;
        None past the bound (the caller runs eager)."""
        with self._lock:
            if key not in self and len(self) < self.bound:
                self[key] = make()
            return self.get(key)
