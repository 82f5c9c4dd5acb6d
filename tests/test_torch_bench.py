"""``bench_torch.py`` on the CPU: its JSON line, its quality gates, and its
numbers against ``bench.py``'s on the same frames.

The reference ``tests/data/bench_96x128_jax_cpu.json`` is ``bench.py``'s
line from

    BENCH_PLATFORM=cpu BENCH_H=96 BENCH_W=128 BENCH_FRAMES=8 BENCH_WARMUP=2 BENCH_REPS=1 python bench.py

and the port replays the JAX mapper's spawn priorities
(``utils/threefry.py::jax_priorities``).  Tolerances are those of the
96x128 entry-point parity test (``test_torch_entry.py::TOL``): ATE 0.05 cm,
PSNR 0.2 dB, depth L1 0.01 cm; gaussians within 1 % (``chip_smoke.py``'s
``REF_TOL``); bin overflow equal, the port's count and JAX's
(``detail.lifecycle_overflow``, which bench.py's line lacks).
"""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench_torch  # noqa: E402
from rtgslam_torch.utils.threefry import jax_priorities  # noqa: E402

torch.set_num_threads(1)
REF = os.path.join(REPO, "tests", "data", "bench_96x128_jax_cpu.json")
TOL = {"ate_cm": 0.05, "psnr": 0.2, "depth_l1_cm": 0.01, "gaussians_rel": 0.01}
# bench.py's detail keys that only its TPU link had: its dispatch-floor
# accounting and the wedge filter
TUNNEL_KEYS = {"dispatch_floor_ms", "device_mapping_ms", "device_tracking_ms",
               "device_fps", "wedge_frames_dropped"}
# the port's detail key that bench.py's line lacks: bench.py's overflow rule
# over the JAX mapper's count (Mapper.lifecycle_overflow), beside the port's
PORT_KEYS = {"lifecycle_overflow"}


def _run(monkeypatch, capsys, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    result = bench_torch.main([], priority_source=jax_priorities())
    lines = capsys.readouterr().out.strip().splitlines()
    return result, json.loads(lines[-1])


def test_bench_matches_jax_reference(monkeypatch, capsys):
    with open(REF) as f:
        ref = json.load(f)
    result, printed = _run(monkeypatch, capsys, **ref["env"])
    want = ref["result"]
    assert printed == result
    assert result["metric"] == want["metric"] == "synthetic_room_online_mapping_fps"
    assert result["unit"] == "fps"
    assert set(result) == set(want)
    assert set(result["detail"]) - PORT_KEYS == set(want["detail"]) - TUNNEL_KEYS
    d, w = result["detail"], want["detail"]
    assert (d["H"], d["W"], d["frames"], d["reps"]) == (96, 128, 8, 1)
    assert len(d["rep_fps"]) == 1 and result["value"] == d["rep_fps"][0]
    assert result["vs_baseline"] == round(result["value"] / 30.0, 4)
    for k in ("ate_cm", "psnr", "depth_l1_cm"):
        assert abs(d[k] - w[k]) <= TOL[k], (k, d[k], w[k])
    assert abs(d["gaussians"] - w["gaussians"]) <= TOL["gaussians_rel"] * w["gaussians"]
    assert d["bin_overflow"] == w["bin_overflow"] == 0
    assert d["lifecycle_overflow"] == w["bin_overflow"]
    assert "perf" not in d


def test_bench_overflow_exits_2(monkeypatch, capsys):
    """A tile capacity of 64 drops entries at 96x128 (one 128-entry chunk
    does not there; this runs the blend's plain versions, which take any
    capacity, where the kernels on the card take whole chunks): the line
    still prints, then the overflow gate exits 2."""
    with pytest.raises(SystemExit) as e:
        _run(monkeypatch, capsys, BENCH_PLATFORM="cpu", BENCH_H=96, BENCH_W=128,
             BENCH_FRAMES=3, BENCH_WARMUP=1, BENCH_REPS=1, BENCH_TILE_CAPACITY=64)
    assert e.value.code == 2
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["detail"]["bin_overflow"] > 0
    assert 0 < line["detail"]["lifecycle_overflow"] <= line["detail"]["bin_overflow"]
    assert "bin_overflow" in out.err


def test_bench_gates_at_the_default_size():
    """PSNR and ATE gate only at 170x300x40; overflow at every size."""
    d = {"H": 170, "W": 300, "frames": 40, "psnr": 27.4, "ate_cm": 0.51,
         "bin_overflow": 0}
    assert len(bench_torch.quality_gates({"detail": d})) == 2
    assert bench_torch.quality_gates({"detail": dict(d, frames=12)}) == []
    assert bench_torch.quality_gates(
        {"detail": dict(d, psnr=27.5, ate_cm=0.5)}) == []
    assert len(bench_torch.quality_gates(
        {"detail": dict(d, frames=12, bin_overflow=3)})) == 1


def test_bench_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_torch.main([])
    assert e.value.code not in (0, None)
