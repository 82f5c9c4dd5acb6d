"""The readers of ``track.filter_kernel_share`` and
``track.filter_ms_per_frame`` (``benchmark/metrics/``) on hand-made run
records: kernel launches over filter calls, the filter's milliseconds per
frame, and None where the program has no ``track.filter`` span (the parent
of the kernel), no ``track.frame`` parent or the run no device timeline."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(HERE))
import manifest  # noqa: E402

NAMES = ("track.filter_kernel_share", "track.filter_ms_per_frame")


def _span(count, total_s):
    return {"count": count, "total_s": total_s, "self_s": total_s,
            "mean_ms": 1e3 * total_s / count, "median_ms": 0.0}


@pytest.fixture(scope="module")
def readers():
    return manifest.readers({"per_layer": [{"name": n} for n in NAMES]}, ROOT,
                            "any")


@pytest.fixture
def run():
    """Eight frames of session 0 before a slice at frame 8; eight filter
    calls, six of them through the kernel."""
    frames = [{"session": 0, "index": i} for i in range(12)]
    spans = {"track.frame": _span(8, 0.8), "track.preprocess": _span(8, 0.2),
             "track.filter": _span(8, 0.004),
             "track.filter_kernel": _span(6, 0.0018)}
    return {"frames": frames, "slice": [8, 11], "spans_before": spans,
            "trace": {"busy_s": 0.4, "window_s": 4.0}}


def test_the_share_is_kernel_launches_over_filter_calls(readers, run):
    read = readers["track.filter_kernel_share"]
    assert read(run) == pytest.approx(75.0)
    del run["spans_before"]["track.filter_kernel"]
    assert read(run) == 0.0


def test_the_filter_time_is_per_frame_before_the_slice(readers, run):
    assert readers["track.filter_ms_per_frame"](run) == pytest.approx(4.0 / 8)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("drop", ["track.filter", "track.frame"])
def test_none_without_the_filter_span_or_its_parent(readers, run, name, drop):
    """The parent program has no ``track.filter`` span; Replica's
    configuration never filters."""
    del run["spans_before"][drop]
    assert readers[name](run) is None


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("trace", [{}, {"busy_s": 0.0, "window_s": 4.0}])
def test_none_without_a_device_timeline(readers, run, name, trace):
    assert readers[name](dict(run, trace=trace)) is None
    assert readers[name](dict(run, spans_before={})) is None
