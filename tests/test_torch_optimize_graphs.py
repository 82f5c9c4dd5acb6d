"""The compact optimize passes replayed as CUDA graphs against the same
passes run eager (card only).

Drives six frames of each benchmark configuration (``benchmark/configs/``,
read only; the frames ray-cast on the card by ``benchmark/scene.py``)
through the per-frame step of ``slam/run.py::run_sequence``.  Every
compact pass the mapper runs (two in six frames of either) runs twice
from the same map: as the program runs it, its stages captured at the
second iteration and replayed from then on, and eager
(``optimize.use_stages`` off).  The two must leave the same map bit for
bit (Adam's eps of 1e-15 makes a one-ulp change a step the size of the
learning rate) and return the same report; each replayed pass makes three
graphs, and none outlives its pass (one more graph, made before the first
pass by ``utils/cuda_graphs.py::thread_pool``, holds the thread's memory
pool).

On a machine with an NVIDIA GPU (the tests' conftest needs JAX):

    python -m pytest tests/test_torch_optimize_graphs.py --noconftest -o addopts="" -s
"""

import dataclasses
import gc
import json
import os
import sys
import weakref

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from rtgslam_torch.config import OptimizationParams  # noqa: E402
from rtgslam_torch.models import optimize  # noqa: E402
from rtgslam_torch.models.gaussian_map import MapState  # noqa: E402
from rtgslam_torch.slam.mapper import Mapper  # noqa: E402
from rtgslam_torch.slam.tracker import Tracker  # noqa: E402
from rtgslam_torch.utils import cuda_graphs, perf  # noqa: E402
from test_torch_sync_spans import FRAMES, _cell  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from rtgslam_torch import setup_device

    return setup_device("cuda:0")


def _copy(state: MapState) -> MapState:
    return MapState(**{f.name: getattr(state, f.name).clone()
                       for f in dataclasses.fields(MapState)})


def _checked_passes(monkeypatch):
    """Patch ``optimize.optimize_execute`` to run each pass replayed and
    eager from the same map; returns the list of each pass's findings."""
    run = optimize.optimize_execute
    found = []

    def checked(state, *args):
        before = _copy(state)
        made = []

        class Counted(torch.cuda.CUDAGraph):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(weakref.ref(self))

        replays = perf.report().get("optimize.replay", {}).get("count", 0)
        with monkeypatch.context() as mp:
            mp.setattr(torch.cuda, "CUDAGraph", Counted)
            report = run(state, *args)
        torch.cuda.synchronize()
        gc.collect()
        eager = _copy(before)
        with monkeypatch.context() as mp:
            mp.setattr(optimize, "use_stages", lambda *a: False)
            want = run(eager, *args)
        found.append({
            "iters": int(args[13]), "graphs": len(made),
            "graphs_alive": sum(r() is not None for r in made),
            "replays": perf.report().get("optimize.replay", {}).get(
                "count", 0) - replays,
            "unequal_fields": [f.name for f in dataclasses.fields(MapState)
                               if not torch.equal(getattr(state, f.name),
                                                  getattr(eager, f.name))],
            "unequal_report": [k for k in optimize.REPORT_KEYS
                               if not torch.equal(report[k], want[k])],
            "reserved_bytes": torch.cuda.memory_reserved()})
        return report

    monkeypatch.setattr(optimize, "optimize_execute", checked)
    return found


def _run_frames(config, device):
    import scene
    import session

    cfg, mix = _cell(config)
    H, W = cfg["frame_size"]
    args = session.make_args(cfg)
    seq = scene.make_sequence(mix["sensor"], mix["motion"], H, W, FRAMES, device)
    opt = OptimizationParams().extract(args)
    tracker, mapper = Tracker(args, device), Mapper(args, device)
    for i, cam in enumerate(session.cameras(seq)):
        fm = tracker.map_preprocess(cam, i)
        tracker.tracking(cam, fm)
        mapper.update_poses(tracker.get_new_poses())
        mapper.mapping(cam, fm, i, opt)
        mapper.get_render_output(cam)
        tracker.update_last_status(
            cam, mapper.model_map["render_depth"],
            mapper.frame_map["depth_map"], mapper.model_map["render_normal"],
            mapper.frame_map["normal_map_w"])
        mapper.time += 1


@pytest.mark.parametrize("config", ["tum_480x640", "replica_680x1200"])
def test_replayed_pass_is_bitwise_the_eager_pass(config, device, monkeypatch):
    monkeypatch.setattr(perf, "ENABLED", True)
    perf.reset()
    cuda_graphs.thread_pool(device)   # the thread's pool and its holder graph
    found = _checked_passes(monkeypatch)
    try:
        _run_frames(config, device)
    finally:
        perf.reset()
    print("[graphs] " + json.dumps({"config": config, "passes": found}))
    assert len(found) >= 2, "fewer than two compact passes ran"
    for p in found:
        assert p["graphs"] == 3 and p["graphs_alive"] == 0, p
        assert p["replays"] == p["iters"] - 1, p
        assert not p["unequal_fields"] and not p["unequal_report"], p
