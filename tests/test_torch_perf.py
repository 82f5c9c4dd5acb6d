"""Port parity: the host spans of ``utils/perf.py`` and the mapper's
TensorBoard scalars, on a 3-frame run of ``bench.py::run_rep``'s loop in
both packages (96x128, a one-iteration local pass on frame 0, the port
replaying the JAX mapper's spawn priorities).

- With spans on, the port's ``report()`` has every key of the JAX
  package's but ``NO_PORT_STAGE`` with the same call counts and JAX's
  fields (plus ``self_s``), and beyond them exactly the port's own spans
  (``PORT_ONLY``: the layer parents and the wait spans at its host syncs),
  each with its count on this run.
- With spans off, a run records nothing.
- Spans nest per thread (``self_s`` is the time outside the direct
  children; two threads never nest into each other's spans) and, while a
  ``torch.profiler`` records, open ``stage:<name>`` ranges that the
  benchmark's breakdown names its idle gaps by.
- The ``train/*`` scalars in the port's event file are the reports its
  local pass returned, and have the JAX run's tags and step, with values
  within the optimize parity tests' 1e-5 (relative) of the JAX run's.  The
  pass takes one iteration: the maps agree to rounding before it, and from
  the second iteration on Adam's eps 1e-15 turns rounding-level gradients
  into whole-lr steps (at 96x128 a second iteration moves the depth loss
  1.2 % off JAX's).
"""

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import bench_torch  # noqa: E402
from rtgslam_torch.config import OptimizationParams  # noqa: E402
from rtgslam_torch.slam.run import make_args  # noqa: E402
from rtgslam_torch.utils import perf  # noqa: E402
from rtgslam_torch.utils.threefry import jax_priorities  # noqa: E402
from rtgslam_tpu.utils import perf as jperf  # noqa: E402

torch.set_num_threads(1)
H, W, FRAMES = 96, 128, 3
# JAX report keys the port has no stage for: the JAX mapper timed the
# keyframe's copy to the host; the port's keyframe keeps its device maps (a
# list append, no device work to time)
NO_PORT_STAGE = ("map.keyframe_offload",)
# the port's own spans and their calls on this run: the layer parents, the
# stages the benchmark's per-layer metrics read, and the wait spans
# (``*_fetch``, ``*upload``) at the host syncs of this path
PORT_ONLY = {
    "track.frame": FRAMES, "track.preprocess": FRAMES,
    "track.tensor_upload": 4,      # K and the first pose; two prior poses
    "track.solve": 2,              # one ICP solve a frame after the first
    "map.frame": FRAMES,
    "map.camera_upload": 5,        # spawn, lifecycle, the pass; two chains
    "map.constant_upload": 9,      # three a spawn
    "map.overflow_fetch": 5,       # spawn and lifecycle; two a chain
    "map.rows_fetch": 14,          # spawn 3 then 4 a frame; 1 a lifecycle
    "map.segment_fetch": 9,        # three error sums a lifecycle
    "render.prepare": 5,
    "optimize.prepare": 2, "optimize.size_fetch": 2,
    "optimize.constant_upload": 1, "optimize.iter": 1,
    "optimize.rows_fetch": 1,
}
JAX_FIELDS = {"count", "total_s", "mean_ms", "median_ms"}
SCALAR_RTOL = 1e-5     # test_torch_optimize.py::_compare_reports


def _configure(args, save_path):
    args.gaussian_update_iter = 1       # one local pass, on frame 0
    args.use_tensorboard = True
    args.mode = "single process"
    args.save_path = str(save_path)
    return args


def _scalars(path):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    acc = EventAccumulator(path)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX report, port report, JAX scalars, port scalars, the port's
    local-pass reports)."""
    from rtgslam_tpu.data.synthetic import make_cameras as jmake
    from rtgslam_torch.data.synthetic import make_cameras as tmake
    from rtgslam_torch.slam.mapper import Mapper

    tmp = tmp_path_factory.mktemp("perf")
    mp = pytest.MonkeyPatch()
    mp.setattr(jperf, "ENABLED", True)
    mp.setattr(perf, "ENABLED", True)
    local_reports = []
    local_optimize = Mapper.local_optimize

    def recorded(self, frame, opt):
        local_reports.append(local_optimize(self, frame, opt))
        return local_reports[-1]

    mp.setattr(Mapper, "local_optimize", recorded)
    try:
        jperf.reset()
        jargs, jopt = bench.make_args(H, W, env_overrides=False)
        jargs = _configure(jargs, tmp / "jax")
        _, _, _, jm = bench.run_rep(jargs, jopt, jmake(FRAMES, H, W), 0)
        jm.tb_writer.flush()
        jrep = jperf.report()

        perf.reset()
        args = _configure(make_args(H, W), tmp / "port")
        _, _, _, pm = bench_torch.run_rep(
            args, OptimizationParams().extract(args), tmake(FRAMES, H, W), 0,
            "cpu", jax_priorities())
        pm.tb_writer.flush()
        prep = perf.report()
    finally:
        mp.undo()
        perf.reset()
    return (jrep, prep, _scalars(str(tmp / "jax")), _scalars(str(tmp / "port")),
            local_reports)


def test_report_keys_match_jax(runs):
    jrep, prep = runs[:2]
    assert set(NO_PORT_STAGE) <= set(jrep)
    shared = set(jrep) - set(NO_PORT_STAGE)
    assert set(prep) == shared | set(PORT_ONLY)
    for k, v in prep.items():
        assert set(v) == JAX_FIELDS | {"self_s"}
        want = jrep[k]["count"] if k in shared else PORT_ONLY[k]
        assert v["count"] == want, k
    assert prep["track.upload"]["count"] == FRAMES
    assert prep["map.local_optimize"]["count"] == 1


def test_no_spans_when_off():
    assert not perf.ENABLED     # RTG_PERF is not set for the tests
    args = _configure(make_args(H, W), "unused")
    args.use_tensorboard = False
    from rtgslam_torch.data.synthetic import make_cameras

    bench_torch.run_rep(args, OptimizationParams().extract(args),
                        make_cameras(FRAMES, H, W), 0, "cpu")
    assert perf.report() == {}


def test_tensorboard_scalars_match_jax(runs):
    _, _, jsc, psc, reports = runs
    assert jsc and set(psc) == set(jsc)
    assert set(psc) == {f"train/{k}" for k in reports[0]}
    for tag, want in jsc.items():
        got = psc[tag]
        assert [v for _, v in got] == [np.float32(r[tag[6:]]) for r in reports]
        assert [s for s, _ in got] == [s for s, _ in want] == [0], tag
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                                   rtol=SCALAR_RTOL, atol=1e-8, err_msg=tag)


def test_device_trace_writes_a_profiler_trace(tmp_path, monkeypatch):
    """``RTG_TRACE=<dir>`` records the block with torch.profiler and writes
    its Chrome trace there; unset, nothing is written."""
    import json

    with perf.device_trace():
        torch.ones(4).sum()
    monkeypatch.setenv("RTG_TRACE", str(tmp_path / "trace"))
    with perf.device_trace():
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    (path,) = (tmp_path / "trace").iterdir()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" == e.get("name", "")
               for e in events)


def test_dump_writes_the_report_of_real_spans(runs, tmp_path, monkeypatch):
    """``dump`` writes ``report()`` of spans that ran; each of its entries
    has JAX's four fields, with the run's counts for the JAX stages."""
    import json

    jrep, prep = runs[:2]
    monkeypatch.setattr(perf, "ENABLED", True)
    perf.reset()
    try:
        for _ in range(3):
            with perf.span("map.counter_fetch"):
                torch.ones(8).sum()
        perf.dump(str(tmp_path / "perf.json"))
        with open(tmp_path / "perf.json") as f:
            written = json.load(f)
        assert written == perf.report()
        assert set(written) == {"map.counter_fetch"}
        assert written["map.counter_fetch"]["count"] == 3
        assert set(jrep["map.counter_fetch"]) == JAX_FIELDS
        assert set(written["map.counter_fetch"]) - {"self_s"} == JAX_FIELDS
        assert prep["map.counter_fetch"]["count"] == jrep["map.counter_fetch"]["count"]
    finally:
        perf.reset()


@pytest.fixture
def spans_on(monkeypatch):
    monkeypatch.setattr(perf, "ENABLED", True)
    perf.reset()
    yield
    perf.reset()


def test_self_time_is_total_less_the_direct_children(spans_on):
    import time

    with perf.span("outer"):
        time.sleep(0.01)
        for _ in range(2):
            with perf.span("inner"):
                time.sleep(0.005)
                with perf.span("leaf"):
                    time.sleep(0.005)
    rep = perf.report()
    assert perf.current() is None
    assert rep["outer"]["count"] == 1 and rep["inner"]["count"] == 2
    # the grandchild is charged to its parent, not to the outer span
    assert rep["outer"]["self_s"] == pytest.approx(
        rep["outer"]["total_s"] - rep["inner"]["total_s"], abs=2e-4)
    assert rep["inner"]["self_s"] == pytest.approx(
        rep["inner"]["total_s"] - rep["leaf"]["total_s"], abs=2e-4)
    assert rep["leaf"]["self_s"] == rep["leaf"]["total_s"]
    assert rep["outer"]["self_s"] >= 0.0095


def test_two_threads_spans_do_not_nest(spans_on):
    """The pipelined system's tracker and mapper threads: each span's
    parent is on its own thread's stack."""
    import threading

    opened = threading.Barrier(2)
    seen = {}

    def worker(name):
        with perf.span(name):
            opened.wait()          # both spans open at once
            seen[name] = perf.current()
            opened.wait()

    threads = [threading.Thread(target=worker, args=(n,))
               for n in ("track.frame", "map.frame")]
    with perf.span("main"):
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert perf.current() == "main"
    rep = perf.report()
    assert seen == {"track.frame": "track.frame", "map.frame": "map.frame"}
    # neither thread's span is a child of the main thread's or of the other
    assert rep["main"]["self_s"] == rep["main"]["total_s"]
    for name in ("track.frame", "map.frame"):
        assert rep[name]["self_s"] == rep[name]["total_s"]


def test_threads_lose_no_span(spans_on):
    """More threads than cores, each timing nested spans, with the switch
    interval shortened: every call is recorded, and each thread's outer
    span has its own inner ones as children."""
    import threading

    threads_n, calls = 2 * (os.cpu_count() or 1) + 2, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(calls):
                with perf.span("outer"):
                    with perf.span("inner"):
                        pass

        threads = [threading.Thread(target=worker) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    rep = perf.report()
    assert rep["outer"]["count"] == rep["inner"]["count"] == threads_n * calls
    assert perf.current() is None


def _work():
    with perf.span("render.prepare"):
        (torch.ones(16, 16) @ torch.ones(16, 16)).sum()


@pytest.mark.parametrize("on", [True, False])
def test_a_span_is_a_profiler_range_only_while_it_records(on, monkeypatch):
    """With spans on, a span opens ``stage:<name>`` in a recording
    ``torch.profiler`` (CPU); not outside a profile, and never with spans
    off."""
    monkeypatch.setattr(perf, "ENABLED", on)
    from torch.autograd import profiler
    from torch.profiler import ProfilerActivity, profile

    opened = []
    enter = profiler.record_function.__enter__
    monkeypatch.setattr(profiler.record_function, "__enter__",
                        lambda self: opened.append(self.name) or enter(self))
    perf.reset()
    try:
        _work()                               # no profiler recording
        assert opened == []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _work()
        names = [e.name() for e in prof.profiler.kineto_results.events()]
    finally:
        perf.reset()
    assert ("stage:render.prepare" in names) is on
    assert opened == (["stage:render.prepare"] if on else [])


def test_the_breakdown_names_a_gap_inside_a_span_by_the_span(spans_on):
    """``benchmark/trace.py::_host_activity`` names a time inside a program
    span by that span (the innermost ``stage:`` range)."""
    import importlib.util
    import time

    from torch.profiler import ProfilerActivity, profile

    # benchmark/trace.py, by its path (its name is also a standard module's)
    bench_dir = os.path.join(REPO, "benchmark")
    sys.path.insert(0, bench_dir)
    try:
        spec = importlib.util.spec_from_file_location(
            "benchmark_trace", os.path.join(bench_dir, "trace.py"))
        bench_trace = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench_trace)
    finally:
        sys.path.remove(bench_dir)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with perf.span("track.frame"):
            with perf.span("track.backend"):
                time.sleep(0.02)          # host code outside any aten op
    host = sorted((e for e in bench_trace._events(prof) if not e[1]),
                  key=lambda e: e[2])
    (backend,) = [e for e in host if e[0] == "stage:track.backend"]
    assert bench_trace._host_activity(host, (backend[2] + backend[3]) / 2) == \
        "track.backend: host code outside any recorded op"
