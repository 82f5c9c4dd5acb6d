"""Shared helpers of the ``test_torch_*`` parity tests.

The JAX package is the reference: these helpers run its slice loop and
replay its random spawn priorities into the port.

Run as a script to write the JAX-on-CPU references of ``chip_smoke.py``'s
170x300 phases: the forward-only slice (both iteration counts at 0) and,
with ``--optimize``, ``bench.make_args`` unchanged (50 iterations every 6th
frame, 10 final-pass iterations per keyframe):

    JAX_PLATFORMS=cpu python tests/torch_parity.py --frames 12 --height 170 --width 300
    JAX_PLATFORMS=cpu python tests/torch_parity.py --optimize --frames 12 --height 170 --width 300

With ``--entry`` it writes the references of the entry points instead: the
JAX ``write_scene`` output on disk, a child config of
``configs/synthetic/room.yaml`` (``ENTRY_OVERRIDES``), then ``slam.py
--platform cpu`` and ``metric.py --platform cpu`` as subprocesses from the
repository root, summarized by :func:`summarize_run`:

    JAX_PLATFORMS=cpu python tests/torch_parity.py --entry --frames 6 --height 96 --width 128
    JAX_PLATFORMS=cpu python tests/torch_parity.py --entry --frames 12 --height 170 --width 300

``--orb`` adds the TUM operating point's tracking and mapping keys
(``TUM_KEYS``: the pose backend, the depth filter, an optimization pass
every 4th frame) to that child config, so ``slam.py`` tracks through the
native pose backend with loop detection on; ``--mp`` runs the pipelined
``slam_mp.py`` (strict sync, one frame: deterministic) in place of
``slam.py``:

    JAX_PLATFORMS=cpu python tests/torch_parity.py --entry --orb --frames 12 --height 170 --width 300
    JAX_PLATFORMS=cpu python tests/torch_parity.py --mp --frames 5 --height 96 --width 128
    JAX_PLATFORMS=cpu python tests/torch_parity.py --mp --frames 12 --height 170 --width 300

``--port`` runs the port's entry point on the CPU against the reference
those flags name and prints the gaps (``--threads`` sets torch's threads):

    python tests/torch_parity.py --port --entry --orb --height 170 --width 300 --threads 3
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_JSON = os.path.join(REPO, "tests", "data", "slice_170x300_jax_cpu.json")
REF_OPT_JSON = os.path.join(REPO, "tests", "data",
                            "slice_opt_170x300_jax_cpu.json")
ROOM_YAML = os.path.join(REPO, "configs", "synthetic", "room.yaml")

# The entry-point runs' child configs of configs/synthetic/room.yaml, by
# frame size.  Keyframe thresholds low enough that every optimization frame
# is a keyframe, and a stable-confidence threshold that a gaussian passes
# after two optimization calls (confidence grows by one per iteration that
# touches it), so later keyframes run the windowed global optimization.
# 96x128 takes the sizes of tests/conftest.py::base_args.
_KEYFRAMES = {"keyframe_trans_thes": 0.003, "keyframe_theta_thes": 0.25}
ENTRY_OVERRIDES = {
    (96, 128): dict(_KEYFRAMES, map_capacity=8192, temp_capacity=2048,
                    block_capacity=4096, tile_capacity=1024,
                    uniform_sample_num=1500, memory_length=3,
                    gaussian_update_iter=10, gaussian_update_frame=2,
                    max_depth=8.0, stable_confidence_thres=15,
                    final_global_iter=2, save_step=3),
    (170, 300): dict(_KEYFRAMES, stable_confidence_thres=60, save_step=6),
}
# configs/tum_base.yaml's tracking and mapping keys: the staged tracking
# path through the pose backend (loop detection on, as base.yaml has it)
TUM_KEYS = dict(use_gt_pose=False, use_orb_backend=True, orb_useicp=True,
                icp_use_model_depth=True, depth_filter=True,
                gaussian_update_frame=4, icp_normal_threshold=20,
                icp_sample_distance_threshold=0.01,
                icp_sample_normal_threshold=0.01,
                invalid_confidence_thresh=0.5)
# the pipelined entry point: strict sync after every frame, the one policy
# whose result does not depend on thread timing
MP_KEYS = dict(sync_tracker2mapper_method="strict",
               sync_tracker2mapper_frames=1, tracker_max_fps=1000)


def entry_overrides(H: int, W: int, orb: bool = False, mp: bool = False) -> dict:
    """The child config's overrides of an entry-point run at H x W."""
    return dict(ENTRY_OVERRIDES[(H, W)], **(TUM_KEYS if orb else {}),
                **(MP_KEYS if mp else {}))


def reference_name(H: int, W: int, orb: bool = False, mp: bool = False) -> str:
    kind = "mp" if mp else ("entry_orb" if orb else "entry")
    return os.path.join(REPO, "tests", "data", f"{kind}_{H}x{W}_jax_cpu.json")
# left out of the file-set comparisons: matplotlib's plots
PLOTS = ("ate.png", "traj_xy.jpg")


def to_torch(x):
    import torch

    return torch.from_numpy(np.array(x))


def jax_priorities(n_spawns: int, H: int, W: int):
    """The spawn priority vectors the JAX mapper draws: ``PRNGKey(2024)``
    split once per spawn call (mapper.py:117,153), that key split into
    (k1, k2) (map_ops.py:438), one ``uniform([H*W])`` from each
    (map_ops.py:65)."""
    import jax

    key = jax.random.PRNGKey(2024)
    out = []
    for _ in range(n_spawns):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        out.append((np.asarray(jax.random.uniform(k1, (H * W,))),
                    np.asarray(jax.random.uniform(k2, (H * W,)))))
    return out


def replay(priorities):
    """A port priority source returning the recorded vectors in order."""
    def source(spawn_index, n):
        pa, pb = priorities[spawn_index]
        assert pa.shape == (n,)
        return to_torch(pa), to_torch(pb)
    return source


def port_cameras(jax_cams):
    """Fresh port ``Camera`` copies of JAX synthetic cameras (tracking
    rewrites a camera's pose, so the two runs must not share them)."""
    from rtgslam_torch.data.camera import Camera

    return [Camera(uid=c.uid, R=np.array(c.R), T=np.array(c.T), FoVx=c.FoVx,
                   FoVy=c.FoVy, image=np.array(c.image), depth=np.array(c.depth),
                   image_name=c.image_name, cx=c.cx, cy=c.cy,
                   timestamp=c.timestamp, pose_gt=np.array(c.pose_gt))
            for c in jax_cams]


def zero_iteration_mapper(args):
    """The JAX ``Mapper`` with its optimization passes replaced by what they
    compute at ``gaussian_update_iter == final_global_iter == 0``.

    The JAX passes cannot run at zero iterations: ``optimize_execute`` and
    ``run_optimize`` index the empty ``frame_seq`` inside the loop body, which
    fails while tracing.  Their zero-trip result is closed-form:
    ``optimize_execute`` (optimize.py:570-581) scatters the unchanged rows
    back and, in local mode, runs ``history_merge`` over the unstable rows;
    the windowed global pass changes nothing; the final pass is ``fix_all``
    (mapper.py:630-631)."""
    from rtgslam_tpu.models import map_ops
    from rtgslam_tpu.models.gaussian_map import unstable_mask
    from rtgslam_tpu.slam import Mapper

    class ZeroIterationMapper(Mapper):
        def local_optimize(self, frame, opt):
            self.state = map_ops.history_merge(
                self.state, map_ops.capture_history(self.state),
                self.history_merge_max_weight, unstable_mask(self.state))

        def global_optimization(self, opt, select_keyframe_num=-1,
                                is_end=False):
            if select_keyframe_num == -1:
                self.state = map_ops.fix_all_donated(self.state)

    assert int(args.gaussian_update_iter) == 0 == int(args.final_global_iter)
    return ZeroIterationMapper(args)


def jax_mapper(args):
    """The JAX ``Mapper`` for a parity run: :func:`zero_iteration_mapper`
    when both iteration counts are 0, else the real one with its background
    compile threads off (they only warm XLA's cache for the next capacity
    bucket and change no result)."""
    from rtgslam_tpu.slam import Mapper

    if int(args.gaussian_update_iter) == 0 == int(args.final_global_iter):
        return zero_iteration_mapper(args)

    class NoPrewarmMapper(Mapper):
        def _maybe_prewarm_bucket(self, *a, **k):
            pass

        def _maybe_prewarm_execute(self, *a, **k):
            pass

        def _prewarm_prepare(self, *a, **k):
            pass

    return NoPrewarmMapper(args)


def random_gaussians(n, n_rest=15, seed=0):
    """Raw parameters of ``n`` flat gaussians in front of a camera at the
    origin looking down +z (the map fields a checkpoint holds)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    scaling = np.log(rng.uniform(0.03, 0.12, (n, 3))).astype(f32)
    scaling[:, 2] -= 2.5                                  # flat discs
    return {
        "xyz": rng.uniform([-1.2, -0.9, 1.5], [1.2, 0.9, 3.5], (n, 3)).astype(f32),
        "features_dc": rng.normal(0.3, 0.4, (n, 3)).astype(f32),
        "features_rest": rng.normal(0, 0.05, (n, n_rest, 3)).astype(f32),
        "opacity": rng.normal(1.5, 1.0, (n, 1)).astype(f32),
        "scaling": scaling,
        "rotation": (rng.normal(0, 1, (n, 4)) + [2, 0, 0, 0]).astype(f32),
        "confidence": rng.integers(0, 200, (n, 1)).astype(f32),
    }


def mappers_with_same_map(base_args, H, W, n=300, capacity=1024):
    """(args, camera, JAX Mapper, port Mapper on the CPU) holding the same
    map: ``n`` random gaussians, unstable and stable interleaved over
    scattered slots, seen by the first synthetic camera at H x W."""
    import copy

    import jax.numpy as jnp
    from rtgslam_tpu.data.synthetic import make_cameras
    from rtgslam_tpu.models.gaussian_map import STABLE, UNSTABLE
    from rtgslam_tpu.slam import Mapper as JaxMapper
    from rtgslam_torch.models.gaussian_map import MapState
    from rtgslam_torch.slam.mapper import Mapper

    args = copy.copy(base_args)
    args.map_capacity = capacity
    cam = make_cameras(1, H, W)[0]
    g = random_gaussians(n, n_rest=(args.max_sh_degree + 1) ** 2 - 1, seed=4)
    slots = np.sort(np.random.default_rng(5).choice(capacity, n, replace=False))
    jm = JaxMapper(args)
    fields = {}
    for k, v in g.items():
        full = np.array(getattr(jm.state, k))
        full[slots] = v
        fields[k] = jnp.asarray(full)
    status = np.array(jm.state.status)
    status[slots] = np.where(np.arange(n) % 2, STABLE, UNSTABLE)
    jm.state = jm.state.replace(status=jnp.asarray(status), **fields)
    jm._ensure_settings(cam)
    pm = Mapper(args, "cpu")
    pm.state = MapState.from_numpy(
        {f: np.asarray(getattr(jm.state, f)) for f in MapState.__dataclass_fields__})
    pm._ensure_settings(cam)
    return args, cam, jm, pm


def run_jax_sequence(args, cams):
    """The JAX package's slice loop: slam.py:125-157 per frame (non-band
    branch), then update poses, the final global pass and the last
    keyframe's eval (slam.py:163-193), with :func:`jax_mapper`.
    Same return keys as ``rtgslam_torch.slam.run.run_sequence``, without
    the timings."""
    from rtgslam_tpu.config import OptimizationParams
    from rtgslam_tpu.slam import Tracker
    from rtgslam_tpu.slam.eval import eval_frame

    opt = OptimizationParams().extract(args)
    tracker, mapper = Tracker(args), jax_mapper(args)
    counts = []
    for i, cam in enumerate(cams):
        fm = tracker.map_preprocess(cam, i)
        tracker.tracking(cam, fm)
        mapper.update_poses(tracker.get_new_poses())
        mapper.mapping(cam, fm, i, opt)
        mapper.get_render_output(cam)
        tracker.update_last_status(
            cam, mapper.model_map["render_depth"], mapper.frame_map["depth_map"],
            mapper.model_map["render_normal"], mapper.frame_map["normal_map_w"])
        counts.append((mapper.get_unstable_num, mapper.get_stable_num))
        mapper.time += 1
    mapper.update_poses(tracker.get_new_poses())
    mapper.global_optimization(opt, is_end=True)
    eval_cam = cams[mapper.keyframe_list[-1]["frame"].uid]
    metrics = eval_frame(mapper, eval_cam)
    return {
        "poses": np.stack(tracker.pose_es),
        "ate_cm": tracker.eval_ate(),
        "eval": metrics,
        "eval_uid": eval_cam.uid,
        "n_stable": mapper.get_stable_num,
        "n_unstable": mapper.get_unstable_num,
        "counts": counts,
        "max_overflow": max(int(mapper.max_overflow), metrics["bin_overflow"]),
    }


def write_child_config(path: str, parent: str, source_path: str,
                       save_path: str, overrides: dict) -> str:
    """A YAML config whose parent is ``parent`` (an absolute path)."""
    cfg = dict(overrides, parent=parent, source_path=source_path,
               save_path=save_path)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=True)
    return path


def _ply_rows(path: str) -> int:
    with open(path, "rb") as f:
        head = f.read(4096)
    return int(re.search(rb"element vertex (\d+)", head).group(1))


def frame_totals(checkpoint_rows: dict) -> dict:
    """Gaussians in the map at each checkpoint: the rows of its unstable
    and stable pool files (``frame_XXXX/iter_XXXX{.ply,_stable.ply}``)."""
    totals = {}
    for name, rows in checkpoint_rows.items():
        if re.search(r"/iter_\d+(_stable)?\.ply$", name):
            frame = name.split("/")[0]
            totals[frame] = totals.get(frame, 0) + rows
    return totals


def rows_within(got: dict, ref: dict, rel: float) -> list:
    """The checkpoints whose row count differs from the reference's by more
    than ``rel`` of the gaussians the reference map holds at that
    checkpoint.  A pool's split between unstable and stable moves with the
    confidence count (the iterations that touched a gaussian) crossing the
    stable threshold, so a small pool is held against the map it is part
    of."""
    totals = frame_totals(ref)
    return [(name, got.get(name), rows) for name, rows in ref.items()
            if got.get(name) is None
            or abs(got[name] - rows) > rel * totals[name.split("/")[0]]]


def summarize_run(save_path: str) -> dict:
    """What an entry-point run left in ``save_path``: the file sets of
    save_model/ and save_traj/ (without the plots), each checkpoint's row
    count, the poses and ATE, the final keyframe's eval (the newest JSON in
    eval_render/) and the metric CSV's columns, row count and mean row."""
    from rtgslam_torch.utils.traj import ate_rmse

    def files(sub):
        root = os.path.join(save_path, sub)
        return sorted(os.path.relpath(p, root)
                      for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                      if os.path.isfile(p) and os.path.basename(p) not in PLOTS)

    model_files = files("save_model")
    traj = os.path.join(save_path, "save_traj")
    pose_es = np.load(os.path.join(traj, "pose_es.npy"))
    pose_gt = np.load(os.path.join(traj, "pose_gt.npy"))
    evals = glob.glob(os.path.join(save_path, "eval_render", "frame_*.json"))
    final = max(evals, key=lambda p: os.stat(p).st_mtime_ns)
    with open(final) as f:
        final_eval = json.load(f)
    (csv_path,) = glob.glob(os.path.join(save_path, "statis_frame_*.csv"))
    with open(csv_path) as f:
        lines = [l.rstrip("\n").split(",") for l in f if l.strip()]
    columns, body = lines[0], lines[1:]
    mean = dict(zip(columns, body[-1]))
    return {
        "save_model_files": model_files,
        "save_traj_files": files("save_traj"),
        "checkpoint_rows": {p: _ply_rows(os.path.join(save_path, "save_model", p))
                            for p in model_files if p.endswith(".ply")},
        "poses": pose_es.tolist(),
        "ate_cm": ate_rmse(pose_es, pose_gt),
        "final_eval_file": os.path.basename(final),
        "psnr": final_eval["psnr"],
        "depth_l1_cm": final_eval["depth_l1_cm"],
        "final_bin_overflow": final_eval["bin_overflow"],
        "csv_file": os.path.basename(csv_path),
        "csv_columns": columns,
        "csv_rows": len(body) - 1,
        "csv_mean": {k: float(v) for k, v in mean.items() if k != "frame"},
    }


def entry_main(a):
    """Write the entry-point reference of the JAX package (see the module
    docstring)."""
    import time

    from rtgslam_tpu.data.synthetic import write_scene

    overrides = entry_overrides(a.height, a.width, a.orb, a.mp)
    out_path = a.out or reference_name(a.height, a.width, a.orb, a.mp)
    slam_script = "slam_mp.py" if a.mp else "slam.py"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_scene(os.path.join(tmp, "scene"), a.frames, a.height, a.width)
        save = os.path.join(tmp, "out")
        cfg = write_child_config(os.path.join(tmp, "entry.yaml"), ROOM_YAML,
                                 scene, save, overrides)
        logs = {}
        for script in (slam_script, "metric.py"):
            proc = subprocess.run(
                [sys.executable, script, "--platform", "cpu", "--config", cfg],
                cwd=REPO, env=env, capture_output=True, text=True)
            logs[script] = proc.stdout
            if proc.returncode:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise SystemExit(f"{script} failed ({proc.returncode})")
        ref = summarize_run(save)
    # slam_mp.py prints neither line
    counts = re.search(r"stable num: (\d+), unstable num: (\d+)", logs[slam_script])
    overflow = re.search(r"max bin_overflow: (\d+)", logs[slam_script])
    import jax

    flags = " ".join(f for f, on in (("--entry", not a.mp), ("--orb", a.orb),
                                      ("--mp", a.mp)) if on)
    ref.update({
        "command": (f"JAX_PLATFORMS=cpu python tests/torch_parity.py {flags} "
                    f"--frames {a.frames} --height {a.height} --width {a.width}"),
        "config": "configs/synthetic/room.yaml with overrides",
        "entry_point": slam_script,
        "overrides": overrides,
        "frames": a.frames, "height": a.height, "width": a.width,
        "jax_version": jax.__version__,
        "loop_end_counts": (counts and [int(counts.group(1)),
                                        int(counts.group(2))]),
        "max_overflow": overflow and int(overflow.group(1)),
        "seconds": time.perf_counter() - t0,
    })
    with open(out_path, "w") as f:
        json.dump(ref, f, indent=1)
    print(json.dumps({k: ref[k] for k in ("ate_cm", "psnr", "depth_l1_cm",
                                          "loop_end_counts", "max_overflow",
                                          "csv_mean")}))


def port_main(a):
    """Run the port's entry point on the CPU against the reference the
    other flags name (the same scene and child config, JAX's spawn
    priorities) and print the gaps as one JSON line."""
    import time

    import torch

    torch.set_num_threads(a.threads)
    sys.path.insert(0, REPO)
    import metric_torch
    import slam_mp_torch
    import slam_torch
    from rtgslam_torch.data.synthetic import write_scene
    from rtgslam_torch.utils.threefry import jax_priorities

    path = a.out or reference_name(a.height, a.width, a.orb, a.mp)
    with open(path) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_scene(os.path.join(tmp, "scene"), ref["frames"],
                            ref["height"], ref["width"])
        cfg = write_child_config(os.path.join(tmp, "c.yaml"), ROOM_YAML, scene,
                                 os.path.join(tmp, "out"), ref["overrides"])
        os.chdir(REPO)
        (slam_mp_torch if a.mp else slam_torch).main(
            ["--config", cfg, "--device", "cpu"], priority_source=jax_priorities())
        metric_torch.main(["--config", cfg, "--device", "cpu"])
        got = summarize_run(os.path.join(tmp, "out"))
    print(json.dumps({
        "reference": os.path.basename(path), "threads": a.threads,
        "seconds": time.perf_counter() - t0,
        "pose_max_abs": float(np.abs(np.array(got["poses"])
                                     - np.array(ref["poses"])).max()),
        **{k: [got[k], ref[k]] for k in ("ate_cm", "psnr", "depth_l1_cm")},
        "csv_mean_psnr": [got["csv_mean"]["psnr"], ref["csv_mean"]["psnr"]],
        "rows_outside_2pct": rows_within(got["checkpoint_rows"],
                                         ref["checkpoint_rows"], 0.02)}))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--height", type=int, default=170)
    ap.add_argument("--width", type=int, default=300)
    ap.add_argument("--optimize", action="store_true",
                    help="keep bench.make_args' iteration counts")
    ap.add_argument("--entry", action="store_true",
                    help="reference of slam.py + metric.py on a scene on disk")
    ap.add_argument("--orb", action="store_true",
                    help="with --entry: the TUM tracking keys (TUM_KEYS)")
    ap.add_argument("--mp", action="store_true",
                    help="reference of slam_mp.py (strict, 1 frame) + metric.py")
    ap.add_argument("--port", action="store_true",
                    help="run the port on the CPU against that reference "
                         "(read from --out when given) and print the gaps")
    ap.add_argument("--threads", type=int, default=3,
                    help="with --port: torch's CPU threads")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.port:
        return port_main(a)

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    if a.entry or a.mp:
        return entry_main(a)
    out_path = a.out or (REF_OPT_JSON if a.optimize else REF_JSON)
    import bench
    from rtgslam_tpu.data.synthetic import make_cameras

    args, _ = bench.make_args(a.height, a.width, env_overrides=False)
    args.optimize_freeze_binning = False
    config = "bench.make_args(H, W, env_overrides=False)"
    if not a.optimize:
        args.gaussian_update_iter = 0
        args.final_global_iter = 0
        config += ", gaussian_update_iter=0, final_global_iter=0"
    res = run_jax_sequence(args, make_cameras(n_frames=a.frames, H=a.height,
                                              W=a.width))
    ref = {
        "command": ("JAX_PLATFORMS=cpu python tests/torch_parity.py "
                    + ("--optimize " if a.optimize else "")
                    + f"--frames {a.frames} --height {a.height} --width {a.width}"),
        "config": config,
        "frames": a.frames, "height": a.height, "width": a.width,
        "jax_version": jax.__version__,
        "ate_cm": res["ate_cm"],
        "psnr": res["eval"]["psnr"],
        "depth_l1_cm": res["eval"]["depth_l1_cm"],
        "eval_uid": res["eval_uid"],
        "n_stable": res["n_stable"],
        "n_unstable": res["n_unstable"],
        "counts": res["counts"],
        "max_overflow": res["max_overflow"],
        "poses": res["poses"].tolist(),
    }
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(ref, f, indent=1)
    print(json.dumps({k: ref[k] for k in ("ate_cm", "psnr", "depth_l1_cm",
                                          "n_stable", "n_unstable",
                                          "max_overflow")}))


if __name__ == "__main__":
    main()
