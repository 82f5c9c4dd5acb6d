"""The port's one CUDA-graph module (``rtgslam_torch/utils/cuda_graphs.py``).

On the CPU, :class:`GraphCache` with a stand-in maker (no CUDA needed): a
key is made once and then found; past the bound ``add`` gives None and the
cache does not grow; threads adding one key make it once, and threads
adding more keys than the bound make exactly the bound.

On the card (marked ``cuda``, skipped without one), :func:`capture`: with
``warmup``, a replay of a cuBLAS and cuSOLVER step equals the step run
eager bitwise; three steps captured into the thread's pool of
:func:`thread_pool` replay bitwise their eager run, each graph in that
pool, and the pool is kept per thread; the capture stream waits for the
caller's stream and the caller's stream for the capture.

On a machine with an NVIDIA GPU (the tests' conftest needs JAX):

    python -m pytest tests/test_torch_cuda_graphs.py --noconftest -o addopts=""
"""

import os
import sys
import threading
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtgslam_torch.utils import cuda_graphs  # noqa: E402

# -- on the CPU ---------------------------------------------------------------


def _maker(made, key):
    """A stand-in for a capture: records the call, returns a fresh object."""
    def make():
        made.append(key)
        return object()
    return make


@pytest.mark.parametrize("keys, made_keys, found", [
    (["a", "a", "a"], ["a"], [0, 0, 0]),
    (["a", "b", "c", "c", "a"], ["a", "b"], [0, 1, None, None, 0]),
], ids=["found-after-one-make", "none-past-the-bound"])
def test_graph_cache_makes_each_key_once_up_to_the_bound(keys, made_keys,
                                                         found):
    cache, made = cuda_graphs.GraphCache(2), []
    got = [cache.add(k, _maker(made, k)) for k in keys]
    assert made == made_keys
    assert len(cache) == len(made_keys)
    first = {k: got[keys.index(k)] for k in made_keys}
    for k, g, f in zip(keys, got, found):
        if f is None:
            assert g is None and cache.get(k) is None
        else:
            assert g is first[keys[f]] and cache.get(k) is g
    cache.clear()
    assert len(cache) == 0 and cache.get("a") is None


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["one-key", "more-keys-than-the-bound"])
def test_graph_cache_threads_add_under_the_lock(distinct):
    """Sixteen threads add at once, each with a maker slow enough that an
    unlocked check-then-add would make a key twice or pass the bound."""
    n, bound = 16, 4
    cache, made, got = cuda_graphs.GraphCache(bound), [], [None] * n
    start = threading.Barrier(n)

    def worker(i):
        key = f"k{i}" if distinct else "k"
        inner = _maker(made, key)

        def slow():
            time.sleep(0.01)
            return inner()

        start.wait(timeout=30)
        got[i] = cache.add(key, slow)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    if distinct:
        assert len(made) == len(cache) == bound
        assert sum(g is not None for g in got) == bound
        assert {cache.get(k) for k in made} == {g for g in got if g is not None}
    else:
        assert made == ["k"] and len(cache) == 1
        assert all(g is cache.get("k") for g in got)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture only there")
    from rtgslam_torch import setup_device

    return setup_device("cuda:0")


def _system(seed, device):
    """A well-conditioned 6x6 system with four right-hand sides."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(6, 6, generator=g)
    b = torch.randn(6, 4, generator=g)
    return a.to(device), b.to(device)


def _solve(a, b):
    """A cuBLAS product and a cuSOLVER solve: the ICP solve's two libraries."""
    m = a @ a.T + 6.0 * torch.eye(6, device=a.device)
    return torch.linalg.solve_ex(m, b)[0] * 0.5


@pytest.mark.cuda
def test_a_warmed_up_capture_replays_bitwise_eager(device):
    a, b = _system(0, device)
    static_a, static_b = a.clone(), b.clone()
    out = {}

    def step():
        out["x"] = _solve(static_a, static_b)

    graph, = cuda_graphs.capture([step], torch.cuda.Stream(device), warmup=True)
    for seed in (1, 2):
        a, b = _system(seed, device)
        static_a.copy_(a)
        static_b.copy_(b)
        graph.replay()
        got = out["x"].clone()
        want = _solve(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (got - want).abs().max()


@pytest.mark.cuda
def test_three_steps_into_the_thread_pool(device):
    pool, side = cuda_graphs.thread_pool(device)
    assert cuda_graphs.thread_pool(device) == (pool, side)   # kept
    other = []
    worker = threading.Thread(
        target=lambda: other.append(cuda_graphs.thread_pool(device)))
    worker.start()
    worker.join(timeout=60)
    assert not worker.is_alive() and other[0][0] != pool   # one per thread

    x = torch.randn(64, 64, device=device)
    s = {}

    def a():
        s["y"] = x * 2.0 + 1.0

    def c():
        s["z"] = torch.sin(s["y"])

    def a_bwd():
        s["w"] = s["z"] @ s["z"].T

    graphs = cuda_graphs.capture((a, c, a_bwd), side, pool=pool)
    assert len(graphs) == 3 and all(g.pool() == pool for g in graphs)
    for seed in (3, 4):
        x.copy_(torch.randn(64, 64, generator=torch.Generator().manual_seed(
            seed)).to(device))
        for g in graphs:
            g.replay()
        y = x * 2.0 + 1.0
        want = torch.sin(y) @ torch.sin(y).T
        torch.cuda.synchronize()
        assert torch.equal(s["w"], want)


@pytest.mark.cuda
def test_the_streams_wait_for_each_other(device):
    """The caller's stream sleeps before it writes the input and the warm-up
    sleeps before it writes the output: without the capture stream's wait
    the warm-up reads the old input, and without the caller's wait the
    caller reads the output before it is written."""
    x = torch.zeros(1024, device=device)
    out = torch.zeros(1024, device=device)

    def step():
        torch.cuda._sleep(100_000_000)
        out.copy_(x * 2.0)

    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    x.fill_(3.0)
    cuda_graphs.capture([step], torch.cuda.Stream(device), warmup=True)
    got = out.clone()           # on the caller's stream, no host sync
    torch.cuda.synchronize()
    assert torch.equal(got, torch.full_like(got, 6.0))
