"""The pass-by-pass comparison of ``tests/torch_parity.py`` (``--trace``,
``--trace-side``, ``--compare``) and what it found on the TUM keys.

- ``compare_traces`` tables two traces: counts, status, parameter and pose
  gaps and PSNR per pass.
- On the CPU the port's traced run repeats bit for bit, so a departure the
  trace finds against JAX is arithmetic, not the port's own noise; a
  rounding-size change of the input colour (``--perturb``) makes one.
- ``tests/data/orb_trace_170x300.json``: the TUM keys at 170x300, 12
  frames, gradient passes on frames 0, 3, 7 and 11, then the final pass.
  The first departure is the first local pass: the maps differ by rounding
  amplified through Adam's eps 1e-15 (no slot's status differs, frame 0's
  PSNR agrees within 0.01 dB).  From the second pass on, the port's PSNR
  gap to JAX stays within the spread of JAX's own runs under a 2^-22
  perturbation of the frames, and its final keyframe sits closer to JAX
  than either perturbed JAX run, inside their range.  No step was found
  that differs in its semantics.
- ``tests/data/entry_orb_170x300_jax_spread.json``: JAX's final keyframe
  unperturbed and under eight perturbation seeds (``torch_parity.py --orb
  --spread``); the port's lies inside that range.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)
EVIDENCE = os.path.join(REPO, "tests", "data", "orb_trace_170x300.json")
SPREAD = os.path.join(REPO, "tests", "data", "entry_orb_170x300_jax_spread.json")
JAX_PERTURBED = ("jax_perturb_1", "jax_perturb_2")


def _fake_log(shift, status, poses):
    rng = np.random.default_rng(0)
    state = {f: rng.standard_normal((6, 3)).astype(np.float32)
             for f in tp.TRACE_FIELDS if f != "status"}
    state["xyz"] = state["xyz"] + shift
    state["status"] = np.array(status, np.int32)
    return {"passes": [{"time": 0, "kind": "local", "state": state,
                        "psnr": [30.0 + shift]},
                       {"time": 3, "kind": "final", "state": state,
                        "psnr": [31.0, 29.0 - shift]}],
            "poses": [{"time": 2, "poses": np.eye(4)[None] + poses}]}


def test_compare_traces_tables_two_runs(tmp_path):
    tp._write_trace(_fake_log(0.0, [1, 1, 2, 2, 0, 0], 0.0), str(tmp_path / "a"))
    tp._write_trace(_fake_log(0.25, [1, 2, 2, 0, 0, 1], 0.5), str(tmp_path / "b"))
    rows = tp.compare_traces(str(tmp_path / "a"), str(tmp_path / "b"))
    assert [r["pass"] for r in rows] == [0, 1]
    first, last = rows
    assert first["kind"] == ["local", "local"] and last["kind"] == ["final", "final"]
    assert first["unstable"] == [2, 2] and first["stable"] == [2, 2]
    assert first["status_differs"] == 3
    assert first["xyz"] == pytest.approx(0.25) and first["opacity"] == 0.0
    assert first["pose_gap"] == 0.0          # refreshed after pass 0
    assert last["pose_gap"] == 0.5
    assert first["psnr_worst_gap"] == pytest.approx(0.25)
    assert last["psnr_last"] == [29.0, 28.75]


def _port_trace(tmp_path, name, cams, perturb=0):
    """A traced port run on the CPU (the Mapper's methods restored after)."""
    from rtgslam_torch.slam.eval import eval_frame
    from rtgslam_torch.slam.mapper import Mapper
    from rtgslam_torch.slam.run import make_args, run_sequence
    from rtgslam_torch.slam.tracker import Tracker

    mp = pytest.MonkeyPatch()
    for n in ("mapping", "local_optimize", "global_optimization", "update_poses"):
        mp.setattr(Mapper, n, getattr(Mapper, n))
    mp.setattr(Tracker, "map_preprocess", Tracker.map_preprocess)
    log = {"passes": [], "poses": []}
    try:
        tp._install_trace(Mapper, eval_frame,
                          lambda t: t.detach().cpu().numpy().copy(), log)
        if perturb:
            tp._install_perturbation("port", perturb)
        args = make_args(48, 64)
        args.gaussian_update_iter, args.gaussian_update_frame = 4, 2
        args.final_global_iter = 2
        run_sequence(args, copy.deepcopy(cams), "cpu")
    finally:
        mp.undo()
    tp._write_trace(log, str(tmp_path / name))
    return str(tmp_path / name)


def test_port_trace_repeats_and_sees_rounding(tmp_path):
    from rtgslam_torch.data.synthetic import make_cameras

    cams = make_cameras(4, 48, 64)
    a = _port_trace(tmp_path, "a", cams)
    b = _port_trace(tmp_path, "b", cams)
    c = _port_trace(tmp_path, "c", cams, perturb=1)
    same = tp.compare_traces(a, b)
    assert [r["time"] for r in same] == [0, 1, 3, 4]    # frames 0, 1, 3; final
    assert same[-1]["kind"] == ["final", "final"]
    for r in same:
        assert r["status_differs"] == 0 and r["psnr_worst_gap"] == 0.0
        assert max(r[f] for f in ("xyz", "features_dc", "opacity", "scaling")) == 0.0
    moved = tp.compare_traces(a, c)
    assert max(r["psnr_worst_gap"] for r in moved) > 0.0
    assert max(r["features_dc"] for r in moved) > 0.0


@pytest.fixture(scope="module")
def evidence():
    with open(EVIDENCE) as f:
        return json.load(f)


def test_orb_first_departure_is_rounding(evidence):
    """Pass 0 (the first local pass, before any pose is refined) is where
    the port and JAX first part: the same slots alive with the same status
    and frame 0's PSNR within 0.01 dB, but parameters apart by up to a few
    hundredths, as a rounding-size perturbation of JAX's own frames moves
    them (the port's thread count does not: pass 0 repeats bit for bit)."""
    port = evidence["port"][0]
    assert port["kind"] == ["local", "local"] and port["status_differs"] == 0
    assert port["pose_gap"] == 0.0 and port["psnr_worst_gap"] < 0.01
    assert port["xyz"] > 0.0
    for k in JAX_PERTURBED:
        assert evidence[k][0]["status_differs"] == 0 and evidence[k][0]["xyz"] > 0.0
    threads = evidence["port_3_threads"][0]
    assert max(threads[f] for f in ("xyz", "features_dc", "scaling")) == 0.0


def test_orb_later_passes_within_jax_spread(evidence):
    """From the second pass on, the port's worst PSNR gap to JAX is within
    what perturbing JAX's own frames by 2^-22 gives, and the final
    keyframe is closer to JAX than either perturbed JAX run."""
    rows = evidence["port"]
    assert [r["time"] for r in rows] == [0, 3, 7, 11, 12]
    for i, r in enumerate(rows[1:], start=1):
        spread = max(evidence[k][i]["psnr_worst_gap"] for k in JAX_PERTURBED)
        assert r["psnr_worst_gap"] <= spread, (i, r["psnr_worst_gap"], spread)

    def last_gap(r):
        return abs(r["psnr_last"][0] - r["psnr_last"][1])

    final = last_gap(rows[-1])
    assert final > 0.8          # why phase 7a holds it to ORB_REF_TOL
    for k in JAX_PERTURBED:
        assert final < last_gap(evidence[k][-1]), k
    # the port's final keyframe, at 1 and 3 threads, lies inside the range
    # of JAX's own runs (unperturbed and perturbed)
    jax_runs = [rows[-1]["psnr_last"][0]] + [evidence[k][-1]["psnr_last"][1]
                                             for k in JAX_PERTURBED]
    for port_psnr in (rows[-1]["psnr_last"][1],
                      evidence["port_3_threads"][-1]["psnr_last"][1]):
        assert min(jax_runs) <= port_psnr <= max(jax_runs), (port_psnr, jax_runs)


def test_orb_final_keyframe_inside_jax_spread(evidence):
    """JAX's own final keyframe over nine runs (unperturbed, then seeds 1-8
    of a 2^-22 colour perturbation) spans [min, max]; the port's CPU runs
    (29.912 at 1 thread, and at 3) lie inside it with no tolerance added.
    Seed 0 is the JAX reference's run and seeds 1 and 2 repeat the trace's
    perturbed runs bit for bit; the file lists every run's command."""
    with open(SPREAD) as f:
        spread = json.load(f)
    runs = spread["runs"]
    assert [r["seed"] for r in runs] == list(range(9))
    assert "--spread" in spread["command"]
    for r in runs:
        assert f"--trace-side jax --perturb {r['seed']} " in r["command"] + " "
    psnr = [r["final_psnr"] for r in runs]
    assert (spread["min"], spread["max"]) == (min(psnr), max(psnr))
    with open(tp.reference_name(170, 300, orb=True)) as f:
        assert runs[0]["final_psnr"] == json.load(f)["psnr"]
    for seed in (1, 2):
        assert runs[seed]["final_psnr"] == \
            evidence[f"jax_perturb_{seed}"][-1]["psnr_last"][1]
    port = evidence["port"][-1]["psnr_last"][1]
    assert port == pytest.approx(29.912, abs=5e-4)
    for p in (port, evidence["port_3_threads"][-1]["psnr_last"][1]):
        assert spread["min"] <= p <= spread["max"], (p, spread["min"],
                                                     spread["max"])
