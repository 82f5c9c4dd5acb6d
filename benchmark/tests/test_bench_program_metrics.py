"""The readers of the port's own spans (``benchmark/metrics/``, through
``_program.py``) on hand-made run records: their arithmetic, and None where
the program has no such span or the run no device timeline."""

import copy
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(HERE))
import manifest  # noqa: E402

NAMES = ("track.syncs_per_frame", "track.loop_check_ms_per_frame",
         "track.backend_ms_per_frame", "map.syncs_per_frame",
         "render.prepare_ms_per_frame", "optimize.prepare_ms_per_pass",
         "optimize.iter_ms_median")


def _span(count, total_s, median_ms=0.0):
    return {"count": count, "total_s": total_s, "self_s": total_s,
            "mean_ms": 1e3 * total_s / count, "median_ms": median_ms}


@pytest.fixture(scope="module")
def readers():
    return manifest.readers({"per_layer": [{"name": n} for n in NAMES]}, ROOT,
                            "any")


@pytest.fixture
def run():
    """Eight frames of session 0 before a slice at frame 8 (and the slice's
    and a later session's frames, which the readers leave out), two gradient
    passes among them."""
    frames = [{"session": 0, "index": i} for i in range(12)]
    frames += [{"session": 1, "index": i} for i in range(12)]
    spans = {
        "track.frame": _span(8, 0.8), "track.preprocess": _span(8, 0.1),
        "track.upload": _span(8, 0.016), "track.pose_fetch": _span(8, 0.24),
        "track.tensor_upload": _span(7, 0.007), "track.dispatch": _span(7, 0.2),
        "track.loop_check": _span(2, 0.06), "track.backend": _span(7, 0.14),
        "track.depth_fetch": _span(2, 0.004), "track.solve_fetch": _span(7, 0.1),
        "map.frame": _span(8, 2.0), "map.counter_fetch": _span(8, 0.01),
        "map.rows_fetch": _span(30, 0.03), "map.camera_upload": _span(18, 0.02),
        "map.local_optimize": _span(1, 0.9), "map.global_optimize": _span(1, 1.1),
        "optimize.prepare": _span(4, 0.08), "optimize.size_fetch": _span(4, 0.004),
        "optimize.iter": _span(100, 1.9, median_ms=18.5),
        "render.prepare": _span(20, 0.32), "render.mask_fetch_not": _span(3, 0.1),
    }
    return {"frames": frames, "slice": [8, 11], "spans_before": spans,
            "trace": {"busy_s": 0.4, "window_s": 4.0}, "iters_per_pass": 50}


def test_sync_counts_are_the_wait_spans_calls_per_frame(readers, run):
    # track: upload 8 + pose 8 + tensor uploads 7 + depth 2 + solve 7
    assert readers["track.syncs_per_frame"](run) == pytest.approx(32 / 8)
    # map, optimize, render: counter 8 + rows 30 + camera 18 + size 4; a
    # span that only contains the word is no wait
    assert readers["map.syncs_per_frame"](run) == pytest.approx(60 / 8)


def test_span_times_per_frame_per_pass_and_the_median(readers, run):
    assert readers["track.loop_check_ms_per_frame"](run) == pytest.approx(60 / 8)
    assert readers["track.backend_ms_per_frame"](run) == pytest.approx(140 / 8)
    assert readers["render.prepare_ms_per_frame"](run) == pytest.approx(320 / 8)
    assert readers["optimize.prepare_ms_per_pass"](run) == pytest.approx(80 / 2)
    assert readers["optimize.iter_ms_median"](run) == 18.5


def test_a_run_without_a_slice_reads_all_its_frames(readers, run):
    run = dict(run, slice=None)
    assert readers["track.syncs_per_frame"](run) == pytest.approx(32 / 24)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_the_programs_spans(readers, run, name):
    """The parent program (no ``track.frame`` or ``map.frame``), a run on the
    CPU (no device timeline) and a run without the span read nothing."""
    assert readers[name](run) is not None
    parent = copy.deepcopy(run)
    del parent["spans_before"]["track.frame"], parent["spans_before"]["map.frame"]
    assert readers[name](parent) is None
    assert readers[name](dict(run, trace={})) is None
    assert readers[name](dict(run, trace={"busy_s": 0.0, "window_s": 4.0})) is None
    assert readers[name](dict(run, spans_before={})) is None


@pytest.mark.parametrize("name,span", [
    ("track.loop_check_ms_per_frame", "track.loop_check"),
    ("track.backend_ms_per_frame", "track.backend"),
    ("render.prepare_ms_per_frame", "render.prepare"),
    ("optimize.prepare_ms_per_pass", "optimize.prepare"),
    ("optimize.iter_ms_median", "optimize.iter")])
def test_none_without_the_span_it_times(readers, run, name, span):
    """Replica's fused tracker has no loop closer and no pose backend."""
    del run["spans_before"][span]
    assert readers[name](run) is None


def test_no_pass_before_the_slice_reads_no_time_per_pass(readers, run):
    for name in ("map.local_optimize", "map.global_optimize"):
        del run["spans_before"][name]
    assert readers["optimize.prepare_ms_per_pass"](run) is None
