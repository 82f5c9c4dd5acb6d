"""Whole runs of a cell on the CPU at a small size: a cell added as files
alone, the traced run's readers, the control, and the run's verdict with the
timed path broken underneath (``correct`` must come out false)."""

import contextlib
import io
import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
import faults  # noqa: E402
import tiny  # noqa: E402

E2E = {"fps", "track_ms_p90", "psnr_db", "ate_cm", "setup_s"}
# the end-to-end metrics that every cell reports, whichever lists it names
E2E_ALL_CELLS = E2E - {"fps"}


def scaled_orbit(root, mix="orbit"):
    path = os.path.join(root, "benchmark", "traffic", mix + ".json")
    with open(path) as f:
        data = json.load(f)
    data["sensor"].update(tiny.orbit_at(128, 96))
    with open(path, "w") as f:
        json.dump(data, f)


def run_cell(root, cell, seed=2 ** 31 + 17, trace=0, seconds=8, **kw):
    import run

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", root=root, **kw)
    assert rc == 0, err.getvalue()[-3000:]
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.fixture
def root(tmp_path):
    r = tiny.make_root(str(tmp_path))
    scaled_orbit(r)
    return r


def unchanged(root):
    """Every file the benchmark had is byte for byte the repository's."""
    for d, _, files in os.walk(os.path.join(tiny.REPO, "benchmark")):
        if "__pycache__" in d or os.sep + "tests" in d:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), tiny.REPO)
            if rel == os.path.join("benchmark", "traffic", "orbit.json"):
                continue   # rescaled to the small frame by this test
            with open(os.path.join(tiny.REPO, rel), "rb") as a, \
                    open(os.path.join(root, rel), "rb") as b:
                assert a.read() == b.read(), rel


def test_a_new_traffic_mix_is_taken_from_its_file_alone(root):
    mix = os.path.join(root, "benchmark", "traffic")
    shutil.copy(os.path.join(mix, "orbit.json"), os.path.join(mix, "orbit_fast.json"))
    with open(os.path.join(mix, "orbit_fast.json")) as f:
        data = json.load(f)
    data["motion"]["frames_per_rev"] = 450
    with open(os.path.join(mix, "orbit_fast.json"), "w") as f:
        json.dump(data, f)
    limits = os.path.join(root, "benchmark", "reference", "limits")
    shutil.copy(os.path.join(limits, tiny.CELL + ".json"),
                os.path.join(limits, tiny.TINY + ".orbit_fast.json"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": tiny.TINY + ".orbit_fast", "config": tiny.TINY,
                               "traffic": "orbit_fast", "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    unchanged(root)
    line, _ = run_cell(root, tiny.TINY + ".orbit_fast")
    assert line["correct"] is True, line["checks"]
    # a cell that no metric's list names reports the metrics held everywhere
    assert set(line["metrics"]) == E2E_ALL_CELLS
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= tiny.TINY_ARGS["frame_num"] and line["failed"] == 0


def test_the_traced_run_reads_its_per_layer_metrics(root):
    line, _ = run_cell(root, tiny.CELL, trace=1)
    assert line["correct"] is True
    # no device on the CPU: the device and kernel readers find nothing
    assert set(line["metrics"]) == {"tracker.ms_median",
                                    "mapper.plain_frame_ms_median",
                                    "optimize.ms_per_iter",
                                    "session.fps_before_slice"}
    assert all(m["value"] > 0 for m in line["metrics"].values())


def test_a_listed_cell_reports_every_end_to_end_metric(root):
    line, _ = run_cell(root, tiny.CELL)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == E2E


def test_the_control_fails_the_replica_cells_limits(root):
    # the Replica cell's own limits on the small copy of its configuration
    shutil.copy(os.path.join(tiny.REPO, "benchmark", "reference", "limits",
                             "replica_680x1200.orbit.json"),
                os.path.join(root, "benchmark", "reference", "limits", tiny.CELL + ".json"))
    line, err = run_cell(root, tiny.CELL, controls=("tf32",))
    assert line["correct"] is True, line["checks"]
    ctrl = [json.loads(x[len("[control] "):]) for x in err.splitlines()
            if x.startswith("[control] ")][0]
    # the control, judged by the run's own verdict, is not correct
    assert ctrl["correct"] is False and ctrl["failed"], ctrl


@pytest.mark.parametrize("fault,caught", [
    ("adam_unchanged", "adam_rel"),
    ("adam_moments_dropped", "adam_rel"),
    ("pose_unchanged", "pose_err_max_cm"),
    ("half_the_tiles", "render_p99"),
    ("pose_altered", "pose_err_max_cm"),
    ("colour_altered", "render_p99"),
])
def test_a_broken_timed_path_is_not_correct(root, fault, caught):
    with faults.FAULTS[fault]():
        line, _ = run_cell(root, tiny.CELL)
    assert line["correct"] is False
    # the fault's own number reads it, not a session cut short
    assert line["checks"][caught]["value"] is not None, line["checks"]
    assert line["checks"][caught]["pass"] is False, line["checks"]


def test_a_frozen_trajectory_is_caught_through_the_pose_backend(tmp_path):
    root = tiny.make_root(str(tmp_path), "tum_480x640", "fr1_desk")
    scaled_orbit(root, "fr1_desk")
    line, _ = run_cell(root, tiny.CELL)
    assert line["correct"] is True, line["checks"]
    with faults.FAULTS["pose_unchanged"]():
        broken, _ = run_cell(root, tiny.CELL)
    assert broken["checks"]["pose_err_max_cm"]["pass"] is False, broken["checks"]


def test_the_sample_falls_on_a_later_pass_and_iteration():
    import correctness

    gradient = [0, 5, 11, 17, 23, 29, 35, 41, 47]
    drawn = {tuple(correctness.draw_sample(seed, gradient, 50).values())
             for seed in (1, 2, 3, 2 ** 31 + 17, 5 * 10 ** 9)}
    assert len(drawn) > 1
    assert all(f in gradient[2:] and 2 <= k < 50 for f, k in drawn)
    assert correctness.draw_sample(7, gradient, 50) == correctness.draw_sample(7, gradient, 50)


def test_a_hooked_name_gone_from_the_port_fails_loudly(monkeypatch):
    import port
    from rtgslam_torch.models import optimize

    port.check()
    monkeypatch.delattr(optimize, "_adam_step")
    with pytest.raises(port.PortChanged, match="_adam_step"):
        port.check()
    with pytest.raises(port.PortChanged, match="_adam_step"):
        with port.patch(optimize, "_adam_step", lambda orig: orig):
            pass


def test_a_hook_that_is_never_called_fails_the_run_loudly(root):
    import port
    from rtgslam_torch.models import optimize

    # a port whose loop no longer calls the hooked Adam step
    fused = optimize._adam_step
    with port.patch(optimize, "_iterate", lambda orig: _iterate_with(orig, fused)):
        with pytest.raises(port.PortChanged, match="adam"):
            run_cell(root, tiny.CELL)


def _iterate_with(orig, step):
    """``optimize._iterate`` calling ``step`` directly, not through the
    module's ``_adam_step``."""
    from rtgslam_torch.models import optimize

    def iterate(*a, **kw):
        hooked = optimize._adam_step
        optimize._adam_step = step
        try:
            return orig(*a, **kw)
        finally:
            optimize._adam_step = hooked
    return iterate
