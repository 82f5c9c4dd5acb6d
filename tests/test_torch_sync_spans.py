"""Every host sync of the per-frame path sits inside a wait span (card only).

Drives six frames of each benchmark configuration (``benchmark/configs/``,
read only; the frames ray-cast on the card by ``benchmark/scene.py`` from
the configuration's traffic mix) through the per-frame step of
``slam/run.py::run_sequence``: ``map_preprocess`` and ``tracking``,
``update_poses``, ``mapping``, the feedback render (``get_render_output``)
and ``update_last_status``; frame 0's gradient pass and one later one run
in both.  The step runs under ``torch.cuda.set_sync_debug_mode("warn")``,
and every synchronizing call torch flags must happen inside a span whose
name follows the wait rule of ``utils/perf.py`` (``*_fetch``,
``*upload``); each wait span must hold at least one such call.  The
compact passes replay their stages as CUDA graphs from their second
iteration on (``optimize.replay``), and no replayed iteration may hold a
sync at all.  Prints the syncs and the wait spans per frame of each
configuration.

On a machine with an NVIDIA GPU (the tests' conftest needs JAX):

    python -m pytest tests/test_torch_sync_spans.py --noconftest -o addopts="" -s
"""

import json
import os
import sys
import traceback
import warnings
from collections import Counter

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rtgslam_torch.config import OptimizationParams  # noqa: E402
from rtgslam_torch.slam.mapper import Mapper  # noqa: E402
from rtgslam_torch.slam.tracker import Tracker  # noqa: E402
from rtgslam_torch.utils import perf  # noqa: E402

pytestmark = pytest.mark.cuda
FRAMES = 6
SYNC_MESSAGE = "synchronizing CUDA operation"


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda's sync debug mode)")
    # the benchmark's configurations, frames and session helpers (their
    # module names would shadow others, so only where the test runs)
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from rtgslam_torch import setup_device

    return setup_device("cuda:0")


def _cell(config):
    """(configuration, traffic mix) of the benchmark cell that runs
    ``config``."""
    import manifest

    bench = manifest.load(REPO)
    cell = next(w for w in bench["workloads"] if w["config"] == config)
    return manifest.config(bench, REPO, config), manifest.traffic(REPO, cell["traffic"])


def _port_frame() -> str:
    """file:line of the port's innermost frame on the calling stack."""
    for fr in reversed(traceback.extract_stack()):
        if os.sep + "rtgslam_torch" + os.sep in fr.filename \
                and not fr.filename.endswith("perf.py"):
            return f"{os.path.relpath(fr.filename, REPO)}:{fr.lineno}"
    return "outside the port"


def _run_frames(config, device):
    """Six frames of ``config``'s step under the sync debug mode; returns
    the flagged calls as (innermost span, port frame, every open span) and
    the spans' report."""
    import scene
    import session

    cfg, mix = _cell(config)
    H, W = cfg["frame_size"]
    args = session.make_args(cfg)
    seq = scene.make_sequence(mix["sensor"], mix["motion"], H, W, FRAMES, device)
    opt = OptimizationParams().extract(args)
    tracker, mapper = Tracker(args, device), Mapper(args, device)
    flagged = []

    def record(message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE in str(message):
            flagged.append((perf.current(), _port_frame(),
                            perf.open_spans()))

    perf.reset()
    for i, cam in enumerate(session.cameras(seq)):
        torch.cuda.synchronize(device)
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fm = tracker.map_preprocess(cam, i)
                tracker.tracking(cam, fm)
                mapper.update_poses(tracker.get_new_poses())
                mapper.mapping(cam, fm, i, opt)
                mapper.get_render_output(cam)
                tracker.update_last_status(
                    cam, mapper.model_map["render_depth"],
                    mapper.frame_map["depth_map"],
                    mapper.model_map["render_normal"],
                    mapper.frame_map["normal_map_w"])
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize(device)
        mapper.time += 1
    return flagged, perf.report()


@pytest.mark.parametrize("config", ["replica_680x1200", "tum_480x640"])
def test_every_sync_is_inside_a_wait_span(config, device, monkeypatch):
    monkeypatch.setattr(perf, "ENABLED", True)
    try:
        flagged, report = _run_frames(config, device)
    finally:
        perf.reset()
    outside = Counter((span, where) for span, where, _ in flagged
                      if span is None or not perf.is_wait(span))
    by_span = Counter(span for span, _, _ in flagged)
    in_replay = Counter((span, where) for span, where, stack in flagged
                        if "optimize.replay" in stack)
    waits = {k: v["count"] for k, v in report.items() if perf.is_wait(k)}
    print("[sync] " + json.dumps({
        "config": config, "frames": FRAMES,
        "syncs_per_frame": len(flagged) / FRAMES,
        "wait_spans_per_frame": sum(waits.values()) / FRAMES,
        "track_waits_per_frame": sum(
            n for k, n in waits.items() if k.startswith("track.")) / FRAMES,
        "map_waits_per_frame": sum(
            n for k, n in waits.items()
            if k.startswith(("map.", "optimize.", "render."))) / FRAMES,
        "syncs_by_span": dict(sorted(by_span.items(), key=str)),
        "replayed_iterations": report.get("optimize.replay", {}).get("count", 0),
        "wait_spans": waits}))
    assert flagged, "torch flagged no sync: is the debug mode on?"
    assert not outside, "syncs outside a wait span: " + json.dumps(
        [[str(s), w, n] for (s, w), n in sorted(outside.items(), key=str)])
    empty = {k: (n, by_span[k]) for k, n in waits.items() if by_span[k] < n}
    assert not empty, f"wait spans that held no sync (calls, syncs): {empty}"
    assert report.get("optimize.replay", {}).get("count"), \
        "no compact iteration replayed its stages"
    assert not in_replay, "syncs inside a replayed iteration: " + json.dumps(
        [[str(s), w, n] for (s, w), n in sorted(in_replay.items(), key=str)])
