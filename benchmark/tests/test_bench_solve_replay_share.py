"""The reader of ``track.solve_replay_share`` (``benchmark/metrics/``) on
hand-made run records: replays over solves, and None where the program has
no ``track.solve`` span, no ``track.frame`` parent or the run no device
timeline."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(HERE))
import manifest  # noqa: E402

NAME = "track.solve_replay_share"


def _span(count, total_s):
    return {"count": count, "total_s": total_s, "self_s": total_s,
            "mean_ms": 1e3 * total_s / count, "median_ms": 0.0}


@pytest.fixture(scope="module")
def read():
    return manifest.readers({"per_layer": [{"name": NAME}]}, ROOT, "any")[NAME]


@pytest.fixture
def run():
    """Eight frames of session 0 before a slice at frame 8; eight solves:
    six replays, a capture and one eager past the graphs' bound."""
    frames = [{"session": 0, "index": i} for i in range(12)]
    spans = {"track.frame": _span(8, 0.8), "track.pose_fetch": _span(8, 0.24),
             "track.solve": _span(8, 0.08), "track.solve_replay": _span(6, 0.05),
             "track.solve_capture": _span(1, 0.02)}
    return {"frames": frames, "slice": [8, 11], "spans_before": spans,
            "trace": {"busy_s": 0.4, "window_s": 4.0}}


def test_the_share_is_replays_over_solves(read, run):
    assert read(run) == pytest.approx(75.0)
    del run["spans_before"]["track.solve_replay"]
    assert read(run) == 0.0


@pytest.mark.parametrize("drop", ["track.solve", "track.frame"])
def test_none_without_the_solve_span_or_its_parent(read, run, drop):
    """The parent program has no ``track.solve`` span."""
    del run["spans_before"][drop]
    assert read(run) is None


@pytest.mark.parametrize("trace", [{}, {"busy_s": 0.0, "window_s": 4.0}])
def test_none_without_a_device_timeline(read, run, trace):
    assert read(dict(run, trace=trace)) is None
    assert read(dict(run, spans_before={})) is None
