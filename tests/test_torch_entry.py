"""The port's entry points, ``slam_torch.py`` and ``metric_torch.py``, on
the CPU against the JAX package's ``slam.py`` and ``metric.py``.

The reference, ``tests/data/entry_96x128_jax_cpu.json``, is the JAX
package's run on the same 6-frame 96x128 room written to disk ("ours"
layout) with the same child config of ``configs/synthetic/room.yaml``
(its ``overrides``: the sizes of conftest's ``base_args``, 10 iterations
every 2nd frame, keyframe thresholds that make every optimization frame a
keyframe and a stable threshold passed after two calls, so frames 3 and 5
run the windowed global optimization), made by

    JAX_PLATFORMS=cpu python tests/torch_parity.py --entry --frames 6 --height 96 --width 128

The port replays the JAX spawn priority stream.  Adam (eps 1e-15) moves a
parameter whose gradient is at rounding level by a whole learning rate
either way, so the two runs part elementwise from the first iteration
(frame 1's pose already differs by 1.6e-4).  Measured on this run (torch
2.13, jax 0.9): poses 8.5e-4, ATE 0.0247 cm, final PSNR 0.073 dB, depth L1
2.9e-4 cm, checkpoint rows equal but for the 41-row unstable pool of frame
5 (42), the CSV's mean PSNR 0.032 dB and depth L1 0.0056 cm.  Held to:
poses 1e-3, depth L1 0.01 cm and counts 1 % (``test_torch_slice.py``'s
optimize tolerances; a checkpoint's rows within 1 % of the gaussians the
map holds at that checkpoint, ``torch_parity.rows_within``), ATE 0.05 cm and PSNR
0.2 dB (wider than that file's 0.01 / 0.05, which this longer run with
two windowed global calls does not meet; ``chip_smoke.py``'s
``OPT_REF_TOL`` is 0.05 / 0.3), the CSV's SSIM / MS-SSIM / valid ratio
within 0.01, and the same file sets and CSV columns.
"""

import csv
import inspect
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)
REPO = tp.REPO
REF = os.path.join(REPO, "tests", "data", "entry_96x128_jax_cpu.json")
TOL = {"poses": 1e-3, "ate_cm": 0.05, "psnr": 0.2, "depth_l1_cm": 0.01,
       "rows_rel": 0.01, "unit": 0.01}


def _scene(tmp_path, ref):
    from rtgslam_torch.data.synthetic import write_scene

    scene = write_scene(str(tmp_path / "scene"), ref["frames"], ref["height"],
                        ref["width"])
    return tp.write_child_config(str(tmp_path / "entry.yaml"), tp.ROOM_YAML,
                                 scene, str(tmp_path / "out"), ref["overrides"])


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory):
    import metric_torch
    import slam_torch
    from rtgslam_torch.models import optimize
    from rtgslam_torch.utils import perf
    from rtgslam_torch.utils.threefry import jax_priorities

    with open(REF) as f:
        ref = json.load(f)
    tmp = tmp_path_factory.mktemp("entry")
    cfg = _scene(tmp, ref)
    modes = []
    execute = optimize.optimize_execute
    sig = inspect.signature(execute)

    def recording(*a, **k):
        modes.append(sig.bind(*a, **k).arguments["mode"])
        return execute(*a, **k)

    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(REPO)       # a config's relative parent: resolves from here
        mp.setattr(optimize, "optimize_execute", recording)
        mp.setattr(perf, "ENABLED", True)     # RTG_PERF=1
        perf.reset()
        res = slam_torch.main(["--config", cfg, "--device", "cpu"],
                              priority_source=jax_priorities())
        met = metric_torch.main(["--config", cfg, "--device", "cpu"])
    finally:
        mp.undo()
        perf.reset()
    return ref, res, met, tp.summarize_run(str(tmp / "out")), modes


def test_entry_trajectory_and_quality(entry_run):
    ref, res, _, got, _ = entry_run
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0, atol=TOL["poses"])
    assert abs(got["ate_cm"] - ref["ate_cm"]) <= TOL["ate_cm"]
    assert abs(res["ate_cm"] - got["ate_cm"]) < 1e-9
    assert got["final_eval_file"] == ref["final_eval_file"]
    assert abs(got["psnr"] - ref["psnr"]) <= TOL["psnr"]
    assert abs(got["depth_l1_cm"] - ref["depth_l1_cm"]) <= TOL["depth_l1_cm"]
    assert res["final_eval"]["psnr"] == got["psnr"]
    assert res["mapper"].max_overflow == ref["max_overflow"] == 0


def test_entry_windowed_global_ran(entry_run):
    ref, res, _, _, modes = entry_run
    assert modes.count("global") >= 1 and "local" in modes, modes
    mapper = res["mapper"]
    assert [kf["frame"].uid for kf in mapper.keyframe_list] == mapper.optimize_frames_ids
    assert sorted(res["decode_ms"]) == list(range(ref["frames"]))


def test_entry_writes_the_span_report(entry_run):
    """``RTG_PERF=1``: the run's span report lands in ``perf.json`` under
    its save path, a tracked and a mapped frame span for every frame."""
    ref, res, _, _, _ = entry_run
    with open(os.path.join(res["mapper"].save_path, "perf.json")) as f:
        report = json.load(f)
    assert report["track.frame"]["count"] == ref["frames"]
    assert report["map.frame"]["count"] == ref["frames"]
    assert report["map.global_optimize"]["count"] >= 1


def test_entry_checkpoints_and_trajectory_files(entry_run):
    ref, _, _, got, _ = entry_run
    assert got["save_model_files"] == ref["save_model_files"]
    assert got["save_traj_files"] == ref["save_traj_files"]
    assert not tp.rows_within(got["checkpoint_rows"], ref["checkpoint_rows"],
                              TOL["rows_rel"])


def test_entry_metric_csv(entry_run):
    ref, _, met, got, _ = entry_run
    assert got["csv_file"] == ref["csv_file"]
    assert got["csv_columns"] == ref["csv_columns"]
    assert got["csv_rows"] == ref["csv_rows"] == ref["frames"]
    for k, v in ref["csv_mean"].items():
        tol = TOL.get(k, TOL["unit"])
        assert abs(got["csv_mean"][k] - v) <= tol, (k, got["csv_mean"][k], v)
    with open(met["csv"], newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["frame"] for r in rows] == [str(i) for i in range(ref["frames"])] + ["mean"]
    assert len(met["frame_ms"]) == ref["frames"]


def test_entry_points_refuse_the_cpu_unless_asked(tmp_path, monkeypatch):
    import metric_torch
    import slam_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = str(tmp_path / "unused.yaml")
    for main in (slam_torch.main, metric_torch.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(["--config", cfg])
