"""Port parity: the host spans of ``utils/perf.py`` and the mapper's
TensorBoard scalars, on a 3-frame run of ``bench.py::run_rep``'s loop in
both packages (96x128, a one-iteration local pass on frame 0, the port
replaying the JAX mapper's spawn priorities).

- With spans on, the port's ``report()`` has the JAX package's keys (none
  is missing: every JAX stage has its port) with the same call counts,
  and each entry the same fields.
- With spans off, a run records nothing.
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
# JAX report keys the port has no stage for
NO_PORT_STAGE = ()
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
    assert set(prep) == set(jrep) - set(NO_PORT_STAGE)
    for k, v in prep.items():
        assert set(v) == {"count", "total_s", "mean_ms", "median_ms"}
        assert v["count"] == jrep[k]["count"], k
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


def test_count_and_dump_match_jax(tmp_path, monkeypatch):
    """``count`` records a measured duration as one call, as the JAX
    package's does, only with spans on; ``dump`` writes ``report()``."""
    import json

    perf.reset()
    perf.count("map.counter_fetch", 0.002)
    assert perf.report() == {}
    monkeypatch.setattr(perf, "ENABLED", True)
    monkeypatch.setattr(jperf, "ENABLED", True)
    jperf.reset()
    try:
        for mod in (perf, jperf):
            for dt in (0.002, 0.004, 0.010):
                mod.count("map.counter_fetch", dt)
        assert perf.report() == jperf.report()
        assert perf.report()["map.counter_fetch"] == {
            "count": 3, "total_s": 0.016, "mean_ms": 5.333, "median_ms": 4.0}
        perf.dump(str(tmp_path / "perf.json"))
        with open(tmp_path / "perf.json") as f:
            assert json.load(f) == perf.report()
    finally:
        perf.reset()
        jperf.reset()
