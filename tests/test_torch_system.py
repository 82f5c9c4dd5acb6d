"""The port's pipelined system (``rtgslam_torch/slam/system.py``) and its
entry point ``slam_mp_torch.py`` on the CPU, against the JAX package's
``slam_mp.py``.

* Each sync policy (strict, loose, free; 2 frames) runs 5 frames at
  96x128 with mid-run checkpoints and evals (``tests/test_system.py``'s
  case on the port).
* Strict sync after every frame is deterministic: the tracker renders the
  map of the frame just mapped, as the single-process loop does.  Against
  ``tests/data/mp_96x128_jax_cpu.json``, the JAX package's ``slam_mp.py`` +
  ``metric.py`` on the same 5-frame room and child config, made by

      JAX_PLATFORMS=cpu python tests/torch_parity.py --mp --frames 5 --height 96 --width 128

  held to ``test_torch_entry.py``'s tolerances (poses 1e-3, ATE 0.05 cm,
  PSNR 0.2 dB, depth L1 0.01 cm, rows 1 %; measured on the CPU, torch
  2.13, jax 0.9, by ``tests/torch_parity.py --port --mp --height 96
  --width 128``: poses 7.6e-4, ATE 0.0780 vs 0.0550 cm, PSNR 28.773 vs
  28.762 dB, depth L1 0.9203 vs 0.9110 cm), and equal to the port's own
  single-process run of the same config to 1e-6 in every pose.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)
REF = tp.reference_name(96, 128, mp=True)
TOL = {"poses": 1e-3, "ate_cm": 0.05, "psnr": 0.2, "depth_l1_cm": 0.01,
       "rows_rel": 0.01}


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def scene(tmp_path_factory, ref):
    from rtgslam_torch.data.synthetic import write_scene

    return write_scene(str(tmp_path_factory.mktemp("mp") / "scene"),
                       ref["frames"], ref["height"], ref["width"])


def _run(script, tmp, scene, overrides, priorities=True):
    from rtgslam_torch.utils.threefry import jax_priorities

    cfg = tp.write_child_config(str(tmp / "c.yaml"), tp.ROOM_YAML, scene,
                                str(tmp / "out"), overrides)
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(tp.REPO)       # a config's relative parent: resolves from here
        return script.main(["--config", cfg, "--device", "cpu"],
                           priority_source=jax_priorities() if priorities else None)
    finally:
        mp.undo()


@pytest.mark.parametrize("sync", ["strict", "loose", "free"])
def test_pipelined_system(tmp_path, scene, ref, sync):
    import slam_mp_torch

    overrides = dict(ref["overrides"], sync_tracker2mapper_method=sync,
                     sync_tracker2mapper_frames=2, save_step=2)
    res = _run(slam_mp_torch, tmp_path, scene, overrides, priorities=False)
    out = tmp_path / "out"
    assert np.isfinite(res["ate_cm"]) and res["ate_cm"] < 2.0
    assert (out / "save_traj" / "pose_es.npy").exists()
    mapper = res["mapper"]
    assert mapper.get_stable_num + mapper.get_unstable_num > 100
    assert mapper.max_overflow == 0
    assert sorted(res["map_end"]) == list(range(ref["frames"]))
    assert sorted(res["decode_ms"]) == list(range(ref["frames"]))
    frame_dirs = sorted(d for d in os.listdir(out / "save_model")
                        if d.startswith("frame_"))
    assert len(frame_dirs) >= 3, frame_dirs     # mid-run saver thread + final
    for d in frame_dirs:
        assert any(f.startswith("iter_") and f.endswith(".ply")
                   for f in os.listdir(out / "save_model" / d)), d
    assert len([f for f in os.listdir(out / "eval_render")
                if f.endswith(".json")]) >= 2
    perf = json.load(open(out / "performance.json"))
    assert len(perf["samples"]["tracking"]) == len(perf["samples"]["mapping"]) == 5


@pytest.fixture(scope="module")
def strict_one(tmp_path_factory, scene, ref):
    import metric_torch
    import slam_mp_torch

    tmp = tmp_path_factory.mktemp("strict1")
    res = _run(slam_mp_torch, tmp, scene, ref["overrides"])
    cfg = str(tmp / "c.yaml")
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(tp.REPO)
        metric_torch.main(["--config", cfg, "--device", "cpu"])
    finally:
        mp.undo()
    return res, tp.summarize_run(str(tmp / "out"))


def test_strict_one_matches_jax(strict_one, ref):
    res, got = strict_one
    assert ref["overrides"]["sync_tracker2mapper_frames"] == 1
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0, atol=TOL["poses"])
    for k in ("ate_cm", "psnr", "depth_l1_cm"):
        assert abs(got[k] - ref[k]) <= TOL[k], (k, got[k], ref[k])
    assert got["final_eval_file"] == ref["final_eval_file"]
    assert got["save_model_files"] == ref["save_model_files"]
    assert got["save_traj_files"] == ref["save_traj_files"]
    assert not tp.rows_within(got["checkpoint_rows"], ref["checkpoint_rows"],
                              TOL["rows_rel"])
    assert abs(got["csv_mean"]["psnr"] - ref["csv_mean"]["psnr"]) <= TOL["psnr"]
    assert res["mapper"].max_overflow == 0


def test_strict_one_equals_single_process(tmp_path, strict_one, scene, ref):
    """Strict sync after every frame is the single-process loop: the same
    poses as ``slam_torch.py`` on the same config."""
    import slam_torch

    res, got = strict_one
    single = _run(slam_torch, tmp_path, scene, ref["overrides"])
    pose_es = np.load(tmp_path / "out" / "save_traj" / "pose_es.npy")
    np.testing.assert_allclose(np.asarray(got["poses"]), pose_es, rtol=0, atol=1e-6)
    assert single["mapper"].get_stable_num == res["mapper"].get_stable_num


def test_launch_count_is_thread_safe():
    """Both threads add to ``blend.launches``: a shortened switch interval
    and more threads than cores lose no update."""
    from rtgslam_torch.ops.rasterize import blend

    before = blend.launches["blend_fwd"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [blend._count("blend_fwd")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert blend.launches["blend_fwd"] - before == 16 * 2000


def test_system_handoffs_and_devices(tmp_path, scene, ref, monkeypatch):
    """On the CPU the hand-offs pass tensors through unchanged and both
    threads share the device; the default device is CUDA, which raises where
    there is none."""
    from rtgslam_torch.config import DatasetParams, OptimizationParams, read_config
    from rtgslam_torch.data.dataset import Dataset
    from rtgslam_torch.slam import system

    maps = {"depth_map": torch.ones(2, 2, 1), "time": 3}
    assert system._publish({"depth_map": maps["depth_map"]}) is None
    assert system._receive(maps, None, torch.device("cpu")) is maps
    cfg = tp.write_child_config(str(tmp_path / "c.yaml"), tp.ROOM_YAML, scene,
                                str(tmp_path / "out"), ref["overrides"])
    monkeypatch.chdir(tp.REPO)
    args = read_config(cfg)
    args.device_list = [0, 1]
    dataset = Dataset(DatasetParams().extract(args))
    opt = OptimizationParams().extract(args)
    slam = system.SLAM(args, dataset, opt, "cpu")
    assert not slam.two_device and slam.mapper_device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        system.SLAM(args, dataset, opt)
