"""The readers of ``optimize.replay_share`` and
``optimize.capture_ms_per_pass`` (``benchmark/metrics/``) on hand-made run
records: replays over the windowed passes' iterations, capture time over
those passes, and None where the program never captured, the run has no
``map.frame`` parent or no device timeline."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(HERE))
import manifest  # noqa: E402

NAMES = ("optimize.replay_share", "optimize.capture_ms_per_pass")


def _span(count, total_s):
    return {"count": count, "total_s": total_s, "self_s": total_s,
            "mean_ms": 1e3 * total_s / count, "median_ms": 0.0}


@pytest.fixture(scope="module")
def readers():
    return manifest.readers({"per_layer": [{"name": n} for n in NAMES]},
                            ROOT, "any")


@pytest.fixture
def run():
    """Eight frames of session 0 before a slice at frame 8; two local
    passes and a global one of 50 iterations each: 150 iterations, three
    captures of 0.06 s in all, 144 replays (one pass captured, then ran
    eager past its graphs)."""
    frames = [{"session": 0, "index": i} for i in range(12)]
    spans = {"map.frame": _span(8, 2.0), "map.local_optimize": _span(2, 0.6),
             "map.global_optimize": _span(1, 0.3),
             "optimize.iter": _span(150, 0.8),
             "optimize.capture": _span(3, 0.06),
             "optimize.replay": _span(144, 0.5)}
    return {"frames": frames, "slice": [8, 11], "spans_before": spans,
            "trace": {"busy_s": 0.4, "window_s": 4.0}, "iters_per_pass": 50}


def test_the_share_is_replays_over_the_passes_iterations(readers, run):
    read = readers["optimize.replay_share"]
    assert read(run) == pytest.approx(96.0)
    del run["spans_before"]["optimize.replay"]
    assert read(run) == 0.0


def test_the_capture_time_is_over_the_passes(readers, run):
    read = readers["optimize.capture_ms_per_pass"]
    assert read(run) == pytest.approx(20.0)
    del run["spans_before"]["map.global_optimize"]
    assert read(run) == pytest.approx(30.0)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("drop", ["optimize.capture", "map.frame"])
def test_none_without_a_capture_or_the_parent(readers, run, name, drop):
    """The parent program has no ``optimize.capture`` span."""
    del run["spans_before"][drop]
    assert readers[name](run) is None


@pytest.mark.parametrize("name", NAMES)
def test_none_without_a_pass(readers, run, name):
    for k in ("map.local_optimize", "map.global_optimize"):
        del run["spans_before"][k]
    assert readers[name](run) is None


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("trace", [{}, {"busy_s": 0.0, "window_s": 4.0}])
def test_none_without_a_device_timeline(readers, run, name, trace):
    assert readers[name](dict(run, trace=trace)) is None
    assert readers[name](dict(run, spans_before={})) is None
