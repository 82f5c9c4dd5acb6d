"""The tracker's ICP solve as a CUDA graph (``ops/icp.py``).

On the card (marked ``cuda``, skipped without one): on pyramids at 480x640
and 680x1200, a replay equals the eager solve bitwise in the pose and the
residual; two inputs in a row give each its own eager result (no stale
static input, no output overwritten by the next replay); a new shape
captures a new graph; a capture made while another thread launches work
succeeds (``thread_local`` capture).  On the CPU: the per-level intrinsics
equal ``K * s`` with ``[2, 2] = 1`` bitwise, and a solve on CPU tensors
makes no graph and returns what the solve returned before it could replay.

On a machine with an NVIDIA GPU (the tests' conftest needs JAX):

    python -m pytest tests/test_torch_icp_graph.py --noconftest -o addopts=""
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtgslam_torch.ops import icp  # noqa: E402
from rtgslam_torch.utils import perf  # noqa: E402

# configs/base.yaml's solve: three levels of five steps
SETTINGS = dict(downscales=(0.25, 0.5, 1.0), iters=(5, 5, 5), damping=1e-4,
                distance_threshold=0.1,
                normal_threshold=float(np.cos(np.deg2rad(20.0))),
                association="bilinear")
SIZES = [(480, 640), (680, 1200)]


def _intrinsics(H, W, device):
    f = 0.5 * W
    return torch.tensor([[f, 0.0, W / 2 - 0.5], [0.0, f, H / 2 - 0.5],
                         [0.0, 0.0, 1.0]], device=device)


def _depth(H, W, device, shift=0.0):
    """A smooth bumpy surface 1.5-2.5 m away, slid ``shift`` pixels along
    the rows, with a hole."""
    v, u = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                          torch.arange(W, device=device, dtype=torch.float32),
                          indexing="ij")
    u = (u + shift) / W
    v = v / H
    d = 2.0 + 0.3 * torch.sin(6.0 * u) * torch.cos(5.0 * v) + 0.2 * u
    d[H // 3:H // 3 + H // 10, W // 4:W // 4 + W // 10] = 0.0
    return d[..., None]


def _problem(H, W, device, shift=3.0, angle=0.01):
    """The solve's arguments: current and target pyramids and a seed pose
    turned ``angle`` rad about y."""
    K = _intrinsics(H, W, device)
    v1, n1 = icp.build_icp_pyramids(_depth(H, W, device, shift), K, 3)
    v0, n0 = icp.build_icp_pyramids(_depth(H, W, device), K, 3)
    c, s = float(np.cos(angle)), float(np.sin(angle))
    pose = torch.tensor([[c, 0.0, s, 0.01], [0.0, 1.0, 0.0, 0.0],
                         [-s, 0.0, c, 0.0], [0.0, 0.0, 0.0, 1.0]], device=device)
    return (pose, v1, v0, n1, n0, K)


def _solve(problem):
    return icp.icp_solve_all_levels(*problem, **SETTINGS)


def _eager(problem):
    return icp._solve(*problem, *SETTINGS.values())


def _same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)


@pytest.fixture
def spans_on(monkeypatch):
    monkeypatch.setattr(perf, "ENABLED", True)
    perf.reset()
    yield
    perf.reset()


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("s", [0.25, 0.5, 1.0, 1.0 / 3.0])
def test_level_intrinsics_equal_the_scaled_k_bitwise(s):
    K = torch.tensor([[517.3, 0.1, 318.6], [-0.0, 516.5, 255.3],
                      [1e-3, 2e-3, 1.0]])
    want = K * s
    want[2, 2] = 1.0
    got = icp.level_intrinsics(K, s)
    assert torch.equal(got, want)
    assert got.view(torch.int32).equal(want.view(torch.int32))
    assert K[2, 2] == 1.0 and K[0, 0] == np.float32(517.3)   # K untouched


def _solve_before(pose10, vertex1_pyr, vertex0_pyr, normal1_pyr, normal0_pyr,
                  K, downscales, iters, damping, distance_threshold,
                  normal_threshold, association):
    """The solve as it was before it could replay: a host scalar written
    into each level's intrinsics."""
    for level, n_iter in enumerate(iters):
        Ks = K * downscales[level]
        Ks[2, 2] = 1.0
        v1, v0 = vertex1_pyr[level], vertex0_pyr[level]
        n1, n0 = normal1_pyr[level], normal0_pyr[level]
        H, W = v1.shape[:2]
        fv, fn = v1.reshape(-1, 3), n1.reshape(-1, 3)
        src = (fv[:, 0], fv[:, 1], fv[:, 2], fn[:, 0], fn[:, 1], fn[:, 2])
        tgt = icp.pack_target(v0, n0)
        for _ in range(n_iter):
            pose10 = icp.gn_iteration(pose10, src, tgt, H, W, Ks, damping,
                                      distance_threshold, normal_threshold,
                                      association)
    p2p = icp.point2plane_loss(vertex0_pyr[-1],
                               vertex1_pyr[-1] @ pose10[:3, :3].T + pose10[:3, 3],
                               normal0_pyr[-1])
    return pose10, p2p


def test_a_cpu_solve_makes_no_graph_and_returns_what_it_did(spans_on):
    torch.set_num_threads(1)
    problem = _problem(48, 64, "cpu")
    graphs = dict(icp._graphs)
    got = _solve(problem)
    assert icp._graphs == graphs
    _same(got, _solve_before(*problem, **SETTINGS))
    rep = perf.report()
    assert rep["track.solve"]["count"] == 1
    assert "track.solve_replay" not in rep and "track.solve_capture" not in rep


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs capture only there")
    from rtgslam_torch import setup_device

    dev = setup_device("cuda:0")
    icp._graphs.clear()
    yield dev
    icp._graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_replay_equals_eager_bitwise(device, size, spans_on):
    problem = _problem(*size, device)
    want = _eager(problem)
    first = _solve(problem)          # captured, then replayed
    again = _solve(problem)          # replayed
    torch.cuda.synchronize()
    _same(first, want)
    _same(again, want)
    assert len(icp._graphs) == 1
    rep = perf.report()
    assert rep["track.solve"]["count"] == 2
    assert rep["track.solve_capture"]["count"] == 1
    assert rep["track.solve_replay"]["count"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_two_inputs_in_a_row_are_each_their_own(device, size):
    a = _problem(*size, device, shift=3.0, angle=0.01)
    b = _problem(*size, device, shift=-2.0, angle=-0.02)
    want_a, want_b = _eager(a), _eager(b)
    assert not torch.equal(want_a[0], want_b[0])
    _solve(a)                         # the capture
    got_a = _solve(a)
    got_b = _solve(b)
    got_a2 = _solve(a)
    torch.cuda.synchronize()
    _same(got_a, want_a)              # not overwritten by b's replay
    _same(got_b, want_b)
    _same(got_a2, want_a)
    assert len(icp._graphs) == 1


@pytest.mark.cuda
def test_a_new_shape_captures_a_new_graph(device, spans_on):
    small, large = (_problem(*s, device) for s in SIZES)
    _solve(small)
    _solve(large)
    assert len(icp._graphs) == 2
    got = _solve(small)
    torch.cuda.synchronize()
    assert len(icp._graphs) == 2
    _same(got, _eager(small))
    rep = perf.report()
    assert rep["track.solve_capture"]["count"] == 2
    assert rep["track.solve_replay"]["count"] == 1


@pytest.mark.cuda
def test_a_capture_while_another_thread_launches_work(device):
    """The pipelined system's mapper thread keeps its own stream busy,
    allocates and draws random numbers while the tracker thread captures.
    It draws them as the mapper does, from a generator of its own: the
    default CUDA generator is the capture's while it lasts, and another
    thread may not draw from it."""
    stop, started = threading.Event(), threading.Event()
    launched, errors = [], []

    def mapper():
        try:
            gen = torch.Generator(device=device)
            gen.manual_seed(0)
            x = torch.rand(512, 512, generator=gen, device=device)
            with torch.cuda.stream(torch.cuda.Stream(device)):
                while not stop.is_set():
                    x = torch.tanh(x @ x.T * 1e-3) + torch.rand(
                        x.shape, generator=gen, device=device)
                    launched.append(1)
                    started.set()
                torch.cuda.current_stream().synchronize()
        except Exception as e:     # reported by the test's thread below
            errors.append(repr(e))
            started.set()

    problem = _problem(*SIZES[0], device)
    want = _eager(problem)
    worker = threading.Thread(target=mapper)
    worker.start()
    try:
        assert started.wait(timeout=60)
        before = len(launched)
        got = _solve(problem)         # the capture, while the worker runs
        during = len(launched) - before
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive()
    assert not errors, errors
    torch.cuda.synchronize()
    assert len(icp._graphs) == 1
    _same(got, want)
    assert during > 0, "the other thread launched nothing during the capture"
