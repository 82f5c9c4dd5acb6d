"""Shared helpers of the ``test_torch_*`` parity tests.

The JAX package is the reference: these helpers run its slice loop and
replay its random spawn priorities into the port.

Run as a script to write the JAX-on-CPU references of ``chip_smoke.py``'s
170x300 phases: the forward-only slice (both iteration counts at 0) and,
with ``--optimize``, ``bench.make_args`` unchanged (50 iterations every 6th
frame, 10 final-pass iterations per keyframe):

    JAX_PLATFORMS=cpu python tests/torch_parity.py --frames 12 --height 170 --width 300
    JAX_PLATFORMS=cpu python tests/torch_parity.py --optimize --frames 12 --height 170 --width 300
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_JSON = os.path.join(REPO, "tests", "data", "slice_170x300_jax_cpu.json")
REF_OPT_JSON = os.path.join(REPO, "tests", "data",
                            "slice_opt_170x300_jax_cpu.json")


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


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--height", type=int, default=170)
    ap.add_argument("--width", type=int, default=300)
    ap.add_argument("--optimize", action="store_true",
                    help="keep bench.make_args' iteration counts")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    out_path = a.out or (REF_OPT_JSON if a.optimize else REF_JSON)

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
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
