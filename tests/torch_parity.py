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

``--bands N`` runs the row-band path (``frame_bands`` N; ``BAND_ENTRY``:
at 96x128 the child of ``room.yaml`` above tracking at stride 1, at
340x600 a child of ``configs/synthetic/room_mid.yaml`` tracking at stride
2; ``--track-stride S`` replaces the stride).  Its summary adds the banded
final eval's PSNR and depth L1, read from the run's ``[EVAL] final
keyframe (banded xN)`` line (:func:`banded_eval`):

    JAX_PLATFORMS=cpu python tests/torch_parity.py --entry --bands 2 --frames 6 --height 96 --width 128
    JAX_PLATFORMS=cpu python tests/torch_parity.py --entry --bands 2 --frames 12 --height 340 --width 600

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

``--orb --trace`` runs ``slam.py`` and the port in process on that
reference's scene, records the map, every mapped frame's PSNR and the
poses handed to ``update_poses`` after each gradient pass, and prints the
per-pass table; ``--trace-side`` runs one package alone, ``--perturb SEED``
scales the frames' colour by a rounding-size factor, and ``--compare``
tables any two traces.  ``tests/data/orb_trace_170x300.json`` holds the
tables of the port against JAX and of perturbed runs against unperturbed
ones (the commands are in that file):

    python tests/torch_parity.py --orb --trace --height 170 --width 300 --threads 1 --out T
    python tests/torch_parity.py --orb --trace-side jax --perturb 1 --height 170 --width 300 --out T/jax_p1
    python tests/torch_parity.py --compare T/jax T/jax_p1/jax --table F --name jax_perturb_1

``--parallel`` writes the JAX-on-CPU reference of the multi-device path on
a 4-device virtual CPU mesh: ``dp_optimize_step``, ``dp_local_optimize``,
``dp_global_optimize`` and ``sp_optimize_execute`` with a distinct frame
per shard (:func:`parallel_case`), and with ``--mapper`` the slice loop
with ``multi_device`` on (:func:`parallel_mapper_args`):

    python tests/torch_parity.py --parallel
    python tests/torch_parity.py --parallel --mapper --frames 6 --height 96 --width 128

``--overflow`` writes the JAX reference of the lifecycle overflow count at
undersized capacities (:func:`overflow_run`: tests/conftest.py's sizes with
``test_slam_e2e.py::test_overflow_tracked_across_run``'s tile and block
capacities, forward-only, ground-truth poses; with ``--bands 2`` the
row-band step), which ``tests/test_torch_overflow.py`` and ``chip_smoke.py``'s
phase 10d hold the port's ``Mapper.lifecycle_overflow`` to:

    JAX_PLATFORMS=cpu python tests/torch_parity.py --overflow --frames 4 --height 96 --width 128
    JAX_PLATFORMS=cpu python tests/torch_parity.py --overflow --bands 2 --frames 4 --height 96 --width 128

``--orb --spread SEED...`` runs ``--trace-side jax --perturb SEED`` for
each seed (seed 0: unperturbed), two at a time, into ``--out``/jax_pSEED
(a trace already there is read, not run again), and writes the final
keyframe's PSNR of each, the spread of JAX's own result:

    python tests/torch_parity.py --orb --spread 0 1 2 3 4 5 6 7 8 --out T --table tests/data/entry_orb_170x300_jax_spread.json
"""

from __future__ import annotations

import argparse
import contextlib
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
ROOM_MID_YAML = os.path.join(REPO, "configs", "synthetic", "room_mid.yaml")


def slice_reference(H: int, W: int, optimize: bool) -> str:
    """The in-process slice reference at H x W (``REF_JSON`` and
    ``REF_OPT_JSON`` at 170x300)."""
    kind = "slice_opt" if optimize else "slice"
    return os.path.join(REPO, "tests", "data", f"{kind}_{H}x{W}_jax_cpu.json")


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


# the row-band entry runs' parent config and overrides, by frame size:
# 340x600 room_mid.yaml's own keys (tracking at stride 2, 170x300) with the
# keyframe thresholds that put the windowed global pass (over band
# cameras) on the path; 96x128 the whole-frame run's keys, tracking at
# stride 1: at stride 2 (48x64) the ICP turns Adam's rounding-level steps
# into pose gaps of ~7e-3 by frame 1 (ROADMAP.md §3, F5)
BAND_ENTRY = {
    (96, 128): (ROOM_YAML, dict(ENTRY_OVERRIDES[(96, 128)], band_track_stride=1)),
    (340, 600): (ROOM_MID_YAML, dict(_KEYFRAMES, band_track_stride=2)),
}


def entry_parent(H: int, W: int, bands: int = 1) -> str:
    """The parent config of an entry-point run at H x W."""
    return BAND_ENTRY[(H, W)][0] if bands > 1 else ROOM_YAML


def entry_overrides(H: int, W: int, orb: bool = False, mp: bool = False,
                    bands: int = 1, track_stride: int = 0) -> dict:
    """The child config's overrides of an entry-point run at H x W; with
    ``bands`` > 1, ``BAND_ENTRY``'s and ``frame_bands``
    (``track_stride`` > 0 replaces the tracking stride)."""
    if bands > 1:
        out = dict(BAND_ENTRY[(H, W)][1], frame_bands=bands)
        if track_stride:
            out["band_track_stride"] = track_stride
        return out
    return dict(ENTRY_OVERRIDES[(H, W)], **(TUM_KEYS if orb else {}),
                **(MP_KEYS if mp else {}))


def reference_name(H: int, W: int, orb: bool = False, mp: bool = False,
                   bands: int = 1) -> str:
    kind = ("mp" if mp else "entry_orb" if orb else
            "entry_bands" if bands > 1 else "entry")
    return os.path.join(REPO, "tests", "data", f"{kind}_{H}x{W}_jax_cpu.json")


_BANDED = re.compile(r"\[EVAL\] final keyframe \(banded x(\d+)\): psnr "
                     r"([-\d.]+) depthL1 ([-\d.]+)cm")


def reference_parent(ref: dict) -> str:
    """The parent config an entry reference's child config names (absolute;
    references written before ``parent`` was recorded used room.yaml)."""
    return os.path.join(REPO, ref.get("parent", "configs/synthetic/room.yaml"))


class Tee:
    """A stdout that also keeps what was written (for
    ``contextlib.redirect_stdout``): the banded final eval is read from a
    run's printed line on both sides."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stdout
        self.parts = []

    def write(self, s):
        self.parts.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()

    def text(self) -> str:
        return "".join(self.parts)


def banded_eval(log: str) -> dict:
    """The banded final eval of a run's stdout (``slam.py`` and
    ``slam_torch.py`` print the same line): its band count, PSNR and depth
    L1 as printed, to 0.01."""
    (n, psnr, depth), = _BANDED.findall(log)
    return {"banded_n": int(n), "banded_psnr": float(psnr),
            "banded_depth_l1_cm": float(depth)}
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


# ---------------------------------------------------------------------------
# the multi-device path (--parallel)
# ---------------------------------------------------------------------------

PARALLEL_SHARDS = 4
PARALLEL_JSON = os.path.join(REPO, "tests", "data", "parallel_tiny_jax_cpu.json")
PARALLEL_MAPPER_JSON = os.path.join(REPO, "tests", "data",
                                    "parallel_mapper_{H}x{W}_jax_cpu.json")
PARALLEL_LR = 1e-3
PARALLEL_WEIGHTS = {"color_weight": 0.8, "depth_weight": 1.0,
                    "normal_weight": 0.1, "add_depth_thres": 0.1}
PARALLEL_STEPS = 3
# sp_optimize_execute: 6 iterations over the four frames
PARALLEL_SEQ = (0, 1, 2, 3, 1, 2)
# the rows every call may move (the tiny problem's 64 gaussians) and the
# fields the reference keeps of them
PARALLEL_ROWS = 64
PARALLEL_FIELDS = ("xyz", "features_dc", "opacity", "scaling", "rotation",
                   "confidence")


def parallel_case(H: int = 32, W: int = 32):
    """(state fields, stacked frames) as numpy: the tiny problem of
    ``parallel/sharded.py::_tiny_problem`` (both packages build it from the
    same draws) with rows 0-31 stable and 32-63 unstable, random
    confidences, flat discs (so the depth hits pass the normal gate), and
    per frame its own random colour and depth (seed 7; the first four
    columns without depth) and a camera moved 5 cm further along x."""
    from rtgslam_torch.models.gaussian_map import STABLE
    from rtgslam_torch.parallel.sharded import _tiny_problem

    state, frames, _ = _tiny_problem(PARALLEL_SHARDS, H, W)
    st = state.to_numpy()
    fr = {k: v.numpy().copy() for k, v in frames.items()}
    rng = np.random.default_rng(7)
    st["status"][:32] = STABLE
    st["confidence"][:PARALLEL_ROWS, 0] = rng.integers(0, 6, PARALLEL_ROWS)
    st["scaling"][:PARALLEL_ROWS, 2] = np.log(np.float32(0.02))
    fr["color"] = rng.uniform(0.1, 0.9, fr["color"].shape).astype(np.float32)
    fr["depth"] = rng.uniform(1.8, 2.6, fr["depth"].shape).astype(np.float32)
    fr["depth"][:, :, :4] = 0.0
    shift = np.float32(0.05) * np.arange(PARALLEL_SHARDS, dtype=np.float32)
    fr["w2c"][:, 0, 3] = shift
    fr["campos"][:, 0] = -shift
    return st, fr


def parallel_mapper_args(base_args, H: int, W: int):
    """The mapper fixture's config: ``base_args`` (tests/conftest.py's) at
    the slice test's capacities (no overflow), frame-to-model ICP, the
    entry runs' keyframe thresholds, 5 iterations per call and a stable
    threshold that two calls can pass, so frames 0 and 1 run local passes
    and frame 3 the windowed global pass; ``multi_device`` on."""
    import copy

    args = copy.copy(base_args)
    args.tile_capacity, args.block_capacity = 1024, 4096
    args.use_gt_pose, args.icp_use_model_depth = False, True
    for k, v in _KEYFRAMES.items():
        setattr(args, k, v)
    args.gaussian_update_iter = 5
    args.stable_confidence_thres = 8
    args.final_global_iter = 2
    args.multi_device = True
    return args


# tests/conftest.py::base_args's keys over configs/base.yaml
CONFTEST_KEYS = dict(map_capacity=8192, temp_capacity=2048, block_capacity=512,
                     tile_capacity=128, uniform_sample_num=1500,
                     memory_length=3, gaussian_update_iter=10,
                     gaussian_update_frame=2, max_depth=8.0,
                     stable_confidence_thres=30, save_step=10_000)


def depth_holes(depth, gen):
    """``depth`` [H, W] with ~5 % of its pixels zeroed at random (``gen``)
    and a block of a tenth of each side, as a depth sensor leaves holes."""
    import torch

    H, W = depth.shape
    depth = torch.where(torch.rand(depth.shape, generator=gen,
                                   device=depth.device) < 0.05, 0.0, depth)
    depth[H // 3:H // 3 + max(H // 10, 1), W // 4:W // 4 + max(W // 10, 1)] = 0.0
    return depth.contiguous()


def kinect_depth(mix: str, H: int, W: int, device, gen):
    """[H, W] float32 depth on ``device``: the first frame that
    ``benchmark/scene.py`` ray-casts for the traffic mix ``mix`` at H x W,
    with TUM fr1's Kinect noise and 1/5000 m steps
    (``benchmark/traffic/fr1_desk.json``), holes punched by
    :func:`depth_holes`."""
    import torch

    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    import scene

    def traffic(name):
        with open(os.path.join(REPO, "benchmark", "traffic", name + ".json")) as f:
            return json.load(f)

    kinect = traffic("fr1_desk")["sensor"]
    sensor = dict(traffic(mix)["sensor"], depth_noise_k=kinect["depth_noise_k"],
                  depth_scale=kinect["depth_scale"], noise_seed=7)
    seq = scene.make_sequence(sensor, traffic(mix)["motion"], H, W, 1, device)
    depth = torch.as_tensor(seq["depth"][0][..., 0], device=device)
    return depth_holes(depth, gen)


def conftest_args():
    """tests/conftest.py::base_args, for the script (no pytest)."""
    sys.path.insert(0, os.path.join(REPO))
    from rtgslam_tpu.config import read_config

    args = read_config(os.path.join(REPO, "configs", "base.yaml"))
    for k, v in CONFTEST_KEYS.items():
        setattr(args, k, v)
    return args


# ---------------------------------------------------------------------------
# the lifecycle overflow count at undersized capacities (--overflow)
# ---------------------------------------------------------------------------

def overflow_reference(H: int, W: int, bands: int = 1) -> str:
    kind = f"overflow_bands{bands}" if bands > 1 else "overflow"
    return os.path.join(REPO, "tests", "data", f"{kind}_{H}x{W}_jax_cpu.json")


# base_args with test_slam_e2e.py::test_overflow_tracked_across_run's
# undersized tile and block capacities (:196-205), forward-only (the JAX
# side is zero_iteration_mapper) and ground-truth poses
OVERFLOW_KEYS = dict(CONFTEST_KEYS, tile_capacity=64, block_capacity=128,
                     use_gt_pose=True, gaussian_update_iter=0,
                     final_global_iter=0)


def overflow_run(step, mapper, cams, read):
    """``test_overflow_tracked_across_run``'s loop (track and map a frame
    with ``step(i, cam)``, advance the clock) on either package's mapper.
    ``read(mapper)`` gives (the folded count, the pending one or None).
    Returns, per frame, the (unstable, stable) counts and ``read``'s pair
    after the frame."""
    frames = []
    for i, cam in enumerate(cams):
        step(i, cam)
        folded, pending = read(mapper)
        frames.append({"counts": [mapper.get_unstable_num,
                                  mapper.get_stable_num],
                       "folded": folded, "pending": pending})
        mapper.time += 1
    return frames


def whole_frame_step(tracker, mapper, opt):
    """slam.py's whole-frame tracking and mapping, as the e2e test runs it
    (no model feedback: the poses are ground truth)."""
    def step(i, cam):
        fm = tracker.map_preprocess(cam, i)
        tracker.tracking(cam, fm)
        mapper.mapping(cam, fm, i, opt)
    return step


def port_overflow_run(ref: dict, cams, device, mesh=None):
    """The port's side of an ``--overflow`` reference ``ref``: configs/
    base.yaml with its overrides, JAX's spawn priorities, on ``device``
    (``mesh`` to the mapper).  Returns (per-frame records, the lifecycle
    count before and after ``fold_overflow``, the port's
    ``max_overflow``)."""
    from rtgslam_torch.config import OptimizationParams, read_config
    from rtgslam_torch.slam.mapper import Mapper
    from rtgslam_torch.slam.run import track_and_map_banded
    from rtgslam_torch.slam.tracker import Tracker
    from rtgslam_torch.utils.threefry import jax_priorities

    args = read_config(os.path.join(REPO, "configs", "base.yaml"))
    for k, v in ref["overrides"].items():
        setattr(args, k, v)
    opt = OptimizationParams().extract(args)
    tracker = Tracker(args, device)
    mapper = Mapper(args, device, jax_priorities(), mesh)
    step = whole_frame_step(tracker, mapper, opt)
    if int(getattr(args, "frame_bands", 1)) > 1:
        track = [None]

        def step(i, cam):
            track[0] = track_and_map_banded(args, tracker, mapper, cam, i,
                                            opt, track[0])[1]
    frames = overflow_run(step, mapper, cams,
                          lambda m: (m.lifecycle_overflow, m._pending_overflow))
    before = mapper.lifecycle_overflow
    mapper.fold_overflow()
    return frames, before, mapper.lifecycle_overflow, mapper.max_overflow


def overflow_main(a):
    """Write the ``--overflow`` reference: the JAX mapper's ``max_overflow``
    and its pending counter after each frame, and the count before and
    after the hand fold of ``tests/test_slam_e2e.py:191``."""
    import time

    import jax
    from rtgslam_tpu.config import OptimizationParams, read_config
    from rtgslam_tpu.data.synthetic import make_cameras
    from rtgslam_tpu.slam import Tracker

    t0 = time.perf_counter()
    keys = dict(OVERFLOW_KEYS, **({"frame_bands": a.bands} if a.bands > 1 else {}))
    args = read_config(os.path.join(REPO, "configs", "base.yaml"))
    for k, v in keys.items():
        setattr(args, k, v)
    opt = OptimizationParams().extract(args)
    tracker, mapper = Tracker(args), jax_mapper(args)
    step = whole_frame_step(tracker, mapper, opt)
    if a.bands > 1:
        track = [None]

        def step(i, cam):
            track[0] = _jax_banded_step(args, tracker, mapper, cam, i, opt,
                                        track[0])[0]

    def read(m):
        return (int(m.max_overflow),
                None if m._overflow_dev is None else int(m._overflow_dev))

    frames = overflow_run(step, mapper,
                          make_cameras(n_frames=a.frames, H=a.height, W=a.width),
                          read)
    before = int(mapper.max_overflow)
    mapper._cached_hwm()
    ref = {
        "command": (f"JAX_PLATFORMS=cpu python tests/torch_parity.py --overflow "
                    + (f"--bands {a.bands} " if a.bands > 1 else "")
                    + f"--frames {a.frames} --height {a.height} --width {a.width}"),
        "config": "configs/base.yaml with overrides (tests/conftest.py::"
                  "base_args, tile 64 / block 128, forward-only, GT poses"
                  + (f", {a.bands} row bands)" if a.bands > 1 else ")"),
        "overrides": keys,
        "frames": a.frames, "height": a.height, "width": a.width,
        "jax_version": jax.__version__,
        "per_frame": frames,
        "max_overflow_before_fold": before,
        "max_overflow_after_fold": int(mapper.max_overflow),
        "cpu_seconds": time.perf_counter() - t0,
    }
    out = a.out or overflow_reference(a.height, a.width, a.bands)
    with open(out, "w") as f:
        json.dump(ref, f, indent=1)
    print(json.dumps({k: ref[k] for k in (
        "per_frame", "max_overflow_before_fold", "max_overflow_after_fold",
        "cpu_seconds")}))


def _bucket(n, lo, hi):
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def parallel_main(a):
    """Write the ``--parallel`` reference (JAX on a 4-device CPU mesh)."""
    import dataclasses
    import time

    import jax
    import jax.numpy as jnp
    from rtgslam_tpu.models import optimize as jopt
    from rtgslam_tpu.models.gaussian_map import alive_mask, unstable_mask
    from rtgslam_tpu.parallel import (dp_global_optimize, dp_local_optimize,
                                      dp_optimize_step, make_mesh)
    from rtgslam_tpu.parallel.sharded import _tiny_problem
    from rtgslam_tpu.parallel.sp_optimize import sp_optimize_execute

    assert len(jax.devices()) == PARALLEL_SHARDS, jax.devices()
    t0 = time.perf_counter()
    mesh = make_mesh(PARALLEL_SHARDS)
    base, frames, settings = _tiny_problem(PARALLEL_SHARDS)
    st, fr = parallel_case()
    state = base.replace(**{f.name: jnp.asarray(st[f.name])
                            for f in dataclasses.fields(base)})
    window = tuple(jnp.asarray(fr[k]) for k in
                   ("color", "depth", "normal", "w2c", "K", "campos"))
    lrs = {k: jnp.float32(PARALLEL_LR) for k in jopt.PARAM_KEYS}
    weights = {k: jnp.float32(v) for k, v in PARALLEL_WEIGHTS.items()}

    def rows(s):
        return {f: np.asarray(getattr(s, f))[:PARALLEL_ROWS].tolist()
                for f in PARALLEL_FIELDS}

    out = {}
    hyper = dict(weights, hist_opacity=state.opacity,
                 hist_scaling=state.scaling, hist_xyz=state.xyz,
                 hist_rotation_raw=state.rotation)
    batch = frames._replace(**{k: jnp.asarray(fr[k]) for k in fr})
    s, loss = dp_optimize_step(state, batch, alive_mask(state),
                               unstable_mask(state), lrs, hyper, settings,
                               mesh, n_steps=PARALLEL_STEPS)
    out["dp_optimize_step"] = {"total": float(loss), "rows": rows(s)}
    s, loss = dp_local_optimize(state, *window, PARALLEL_STEPS, lrs, weights,
                                settings, mesh, max_weight=0.5)
    out["dp_local_optimize"] = {"total": float(loss), "rows": rows(s)}
    s, loss = dp_global_optimize(state, *window, PARALLEL_STEPS, lrs, weights,
                                 settings, mesh, sample_ratio=0.4)
    out["dp_global_optimize"] = {"total": float(loss), "rows": rows(s)}
    (rmasks, _, lists_orig, counts, pool_order, tile_order, n_pool, cnt_max,
     n_live) = jopt.optimize_prepare(state, *window, settings=settings,
                                     mode="local", sample_ratio=-1.0,
                                     mask_depth_positive=False)
    Ac = _bucket(int(n_pool), 64, pool_order.shape[0])
    Ktc = _bucket(int(cnt_max), 64, lists_orig.shape[-1])
    Tc = _bucket(max(int(n_live), PARALLEL_SHARDS), PARALLEL_SHARDS,
                 counts.shape[-1])
    s, report = sp_optimize_execute(
        state, *window, rmasks, lists_orig, counts, pool_order[:Ac], n_pool,
        tile_order[:, :Tc], jnp.asarray(PARALLEL_SEQ, jnp.int32),
        len(PARALLEL_SEQ), lrs, weights, settings, mode="local",
        max_weight=0.5, Ac=Ac, Ktc=Ktc, Tc=Tc, mesh=mesh)
    out["sp_optimize_execute"] = {
        "report": {k: float(v) for k, v in report.items()}, "rows": rows(s),
        "n_live_tiles": int(n_live), "Tc": Tc}
    ref = {"command": "python tests/torch_parity.py --parallel",
           "mesh": f"{PARALLEL_SHARDS} virtual CPU devices "
                   "(--xla_force_host_platform_device_count)",
           "jax_version": jax.__version__, "steps": PARALLEL_STEPS,
           "seq": list(PARALLEL_SEQ), "lr": PARALLEL_LR,
           "weights": PARALLEL_WEIGHTS, "max_weight": 0.5, "sample_ratio": 0.4,
           "cpu_seconds": time.perf_counter() - t0, **out}
    with open(a.out or PARALLEL_JSON, "w") as f:
        json.dump(ref, f, indent=1)
    print(json.dumps({k: v.get("total", v.get("report")) for k, v in out.items()}))


def parallel_mapper_main(a):
    """Write the ``--parallel --mapper`` reference: the slice loop of
    :func:`run_jax_sequence` with ``multi_device`` on a 4-device CPU mesh."""
    import time

    import jax
    from rtgslam_tpu.data.synthetic import make_cameras

    assert len(jax.devices()) == PARALLEL_SHARDS, jax.devices()
    t0 = time.perf_counter()
    H, W = a.height, a.width
    args = parallel_mapper_args(conftest_args(), H, W)
    res = run_jax_sequence(args, make_cameras(n_frames=a.frames, H=H, W=W))
    ref = {
        "command": (f"python tests/torch_parity.py --parallel --mapper "
                    f"--frames {a.frames} --height {H} --width {W}"),
        "config": "tests/conftest.py::base_args with parallel_mapper_args",
        "mesh": f"{PARALLEL_SHARDS} virtual CPU devices",
        "frames": a.frames, "height": H, "width": W,
        "jax_version": jax.__version__,
        "ate_cm": res["ate_cm"], "psnr": res["eval"]["psnr"],
        "depth_l1_cm": res["eval"]["depth_l1_cm"], "eval_uid": res["eval_uid"],
        "n_stable": res["n_stable"], "n_unstable": res["n_unstable"],
        "counts": res["counts"], "max_overflow": res["max_overflow"],
        "poses": res["poses"].tolist(),
        "cpu_seconds": time.perf_counter() - t0,
    }
    with open(a.out or PARALLEL_MAPPER_JSON.format(H=H, W=W), "w") as f:
        json.dump(ref, f, indent=1)
    print(json.dumps({k: ref[k] for k in ("ate_cm", "psnr", "depth_l1_cm",
                                          "n_stable", "n_unstable",
                                          "max_overflow", "cpu_seconds")}))


def _jax_banded_step(args, tracker, mapper, frame, frame_id, opt,
                     track_settings):
    """slam.py:71-112, the banded per-frame step, as slam.py runs it.
    Returns the track settings and the feedback render's overflow."""
    import jax.numpy as jnp
    from rtgslam_tpu.data.bands import downsample_camera, split_bands
    from rtgslam_tpu.ops.rasterize.api import RasterSettings
    from rtgslam_tpu.slam.tracker import preprocess_and_lift

    n_bands = int(args.frame_bands)
    track_cam = downsample_camera(frame, int(getattr(args, "band_track_stride",
                                                     n_bands)))
    if track_settings is None:
        track_settings = RasterSettings.from_args(
            args, track_cam.image_height, track_cam.image_width)
    frame_map = tracker.map_preprocess(track_cam, frame_id)
    tracker.tracking(track_cam, frame_map)
    frame.update(track_cam.R, track_cam.T)
    mapper.update_poses(tracker.get_new_poses())
    for bcam in split_bands(frame, n_bands, rotate=frame_id):
        bfm = preprocess_and_lift(
            jnp.asarray(bcam.depth, jnp.float32),
            jnp.asarray(bcam.image, jnp.float32),
            jnp.asarray(bcam.intrinsic),
            jnp.asarray(bcam.c2w, jnp.float32),
            args.min_depth, args.max_depth,
            tracker.invalid_confidence_thresh, tracker.depth_filter)
        bfm["time"] = frame_id
        mapper.mapping(bcam, bfm, frame_id, opt)
        mapper.time += 1
    mapper.time -= 1
    out = mapper._render(track_cam.device_dict(), "global",
                         settings=track_settings)
    mapper._set_model_map(out)
    tracker.update_last_status(
        track_cam, mapper.model_map["render_depth"], frame_map["depth_map"],
        mapper.model_map["render_normal"], frame_map["normal_map_w"])
    return track_settings, int(out["overflow"])


def _jax_eval_banded(mapper, cam, n_bands):
    """slam.py:169-186's banded final eval, unrounded."""
    import math

    from rtgslam_tpu.data.bands import split_bands
    from rtgslam_tpu.slam.eval import eval_frame

    per_band = [eval_frame(mapper, b) for b in split_bands(cam, n_bands)]
    mse = sum(10.0 ** (-m["psnr"] / 10.0) for m in per_band) / n_bands
    return {"psnr": -10.0 * math.log10(mse),
            "depth_l1_cm": sum(m["depth_l1_cm"] for m in per_band) / n_bands,
            "bin_overflow": max(m["bin_overflow"] for m in per_band)}


def run_jax_sequence(args, cams):
    """The JAX package's slice loop: slam.py:125-157 per frame (with
    ``frame_bands`` > 1 the banded step, :71-123), then update poses, the
    final global pass and the last keyframe's eval (slam.py:163-193, band by
    band when banded), with :func:`jax_mapper`.  Same return keys as
    ``rtgslam_torch.slam.run.run_sequence``, without the timings."""
    from rtgslam_tpu.config import OptimizationParams
    from rtgslam_tpu.slam import Tracker
    from rtgslam_tpu.slam.eval import eval_frame

    opt = OptimizationParams().extract(args)
    tracker, mapper = Tracker(args), jax_mapper(args)
    n_bands = int(getattr(args, "frame_bands", 1))
    track_settings, feedback_overflow = None, 0
    counts = []
    for i, cam in enumerate(cams):
        if n_bands > 1:
            track_settings, over = _jax_banded_step(args, tracker, mapper, cam,
                                                    i, opt, track_settings)
            feedback_overflow = max(feedback_overflow, over)
        else:
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
    metrics = (_jax_eval_banded(mapper, eval_cam, n_bands) if n_bands > 1
               else eval_frame(mapper, eval_cam))
    return {
        "poses": np.stack(tracker.pose_es),
        "ate_cm": tracker.eval_ate(),
        "eval": metrics,
        "eval_uid": eval_cam.uid,
        "n_stable": mapper.get_stable_num,
        "n_unstable": mapper.get_unstable_num,
        "counts": counts,
        "max_overflow": max(int(mapper.max_overflow), metrics["bin_overflow"]),
        "keyframes": [(kf["frame"].uid, kf["frame"].image_name)
                      for kf in mapper.keyframe_list],
        "feedback_overflow": feedback_overflow,
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

    overrides = entry_overrides(a.height, a.width, a.orb, a.mp, a.bands,
                                a.track_stride)
    parent = entry_parent(a.height, a.width, a.bands)
    out_path = a.out or reference_name(a.height, a.width, a.orb, a.mp, a.bands)
    slam_script = "slam_mp.py" if a.mp else "slam.py"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_scene(os.path.join(tmp, "scene"), a.frames, a.height, a.width)
        save = os.path.join(tmp, "out")
        cfg = write_child_config(os.path.join(tmp, "entry.yaml"), parent,
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
    if a.bands > 1:
        ref.update(banded_eval(logs[slam_script]))
    # slam_mp.py prints neither line
    counts = re.search(r"stable num: (\d+), unstable num: (\d+)", logs[slam_script])
    overflow = re.search(r"max bin_overflow: (\d+)", logs[slam_script])
    import jax

    flags = " ".join(f for f, on in (("--entry", not a.mp), ("--orb", a.orb),
                                      ("--mp", a.mp),
                                      (f"--bands {a.bands}", a.bands > 1),
                                      (f"--track-stride {a.track_stride}",
                                       a.track_stride)) if on)
    ref.update({
        "command": (f"JAX_PLATFORMS=cpu python tests/torch_parity.py {flags} "
                    f"--frames {a.frames} --height {a.height} --width {a.width}"
                    + (f" --out {os.path.relpath(out_path, REPO)}" if a.out else "")),
        "config": f"{os.path.relpath(parent, REPO)} with overrides",
        "parent": os.path.relpath(parent, REPO),
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
    print(json.dumps({k: ref.get(k) for k in (
        "ate_cm", "psnr", "depth_l1_cm", "banded_psnr", "banded_depth_l1_cm",
        "loop_end_counts", "max_overflow", "csv_mean", "seconds")}))


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

    path = a.out or reference_name(a.height, a.width, a.orb, a.mp, a.bands)
    with open(path) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        scene = write_scene(os.path.join(tmp, "scene"), ref["frames"],
                            ref["height"], ref["width"])
        cfg = write_child_config(os.path.join(tmp, "c.yaml"), reference_parent(ref),
                                 scene, os.path.join(tmp, "out"), ref["overrides"])
        os.chdir(REPO)
        log = Tee()
        with contextlib.redirect_stdout(log):
            res = (slam_mp_torch if a.mp else slam_torch).main(
                ["--config", cfg, "--device", "cpu"],
                priority_source=jax_priorities())
        metric_torch.main(["--config", cfg, "--device", "cpu"])
        got = summarize_run(os.path.join(tmp, "out"))
    banded = ({k: [v, ref[k]] for k, v in banded_eval(log.text()).items()}
              if "banded_psnr" in ref else {})
    print(json.dumps({
        "reference": os.path.basename(path), "threads": a.threads,
        "seconds": time.perf_counter() - t0,
        "pose_max_abs": float(np.abs(np.array(got["poses"])
                                     - np.array(ref["poses"])).max()),
        "pose_max_abs_per_frame": np.abs(np.array(got["poses"]) - np.array(
            ref["poses"])).max(axis=(1, 2)).round(6).tolist(),
        **{k: [got[k], ref[k]] for k in ("ate_cm", "psnr", "depth_l1_cm")},
        "csv_mean_psnr": [got["csv_mean"]["psnr"], ref["csv_mean"]["psnr"]],
        **banded,
        # the printed counts: the port's, and JAX's count of the port's run
        # (Mapper.lifecycle_overflow), each against JAX's printed one
        "max_overflow": [res["mapper"].max_overflow, ref["max_overflow"]],
        "lifecycle_overflow": [res["mapper"].lifecycle_overflow,
                               ref["max_overflow"]],
        "rows_outside_2pct": rows_within(got["checkpoint_rows"],
                                         ref["checkpoint_rows"], 0.02)}))


# the map fields a trace keeps after each pass (both packages' MapState)
TRACE_FIELDS = ("xyz", "features_dc", "opacity", "scaling", "rotation",
                "confidence", "status")


def _install_trace(Mapper, eval_frame, to_np, log):
    """Wrap ``Mapper``'s methods so a run records, after each gradient pass,
    the map (``TRACE_FIELDS``) and the PSNR of every frame mapped so far, and
    every pose list handed to ``update_poses``.  Both packages' mappers have
    the same method names and signatures."""
    orig = {n: getattr(Mapper, n) for n in
            ("mapping", "local_optimize", "global_optimization", "update_poses")}
    frames = []

    def snapshot(self, kind):
        log["passes"].append({
            "time": self.time, "kind": kind,
            "state": {f: to_np(getattr(self.state, f)) for f in TRACE_FIELDS},
            "psnr": [float(eval_frame(self, f)["psnr"]) for f in frames]})

    def mapping(self, frame, frame_map, frame_id, opt):
        frames.append(frame)
        return orig["mapping"](self, frame, frame_map, frame_id, opt)

    def local_optimize(self, frame, opt):
        out = orig["local_optimize"](self, frame, opt)
        snapshot(self, "local")
        return out

    def global_optimization(self, opt, select_keyframe_num=-1, **kw):
        out = orig["global_optimization"](self, opt, select_keyframe_num, **kw)
        snapshot(self, "final" if select_keyframe_num == -1 else "global")
        return out

    def update_poses(self, new_poses):
        if new_poses is not None:
            log["poses"].append({"time": self.time,
                                 "poses": np.array(new_poses, np.float64)})
        return orig["update_poses"](self, new_poses)

    for name, fn in (("mapping", mapping), ("local_optimize", local_optimize),
                     ("global_optimization", global_optimization),
                     ("update_poses", update_poses)):
        setattr(Mapper, name, fn)


def _install_perturbation(side, seed):
    """Scale every frame's colour by 1 + u * 2^-22, u uniform in [-1, 1)
    from ``seed``, before tracking: a perturbation of rounding size, to see
    how far a run's result moves with the last bits of its inputs."""
    if side == "jax":
        from rtgslam_tpu.slam import Tracker
    else:
        from rtgslam_torch.slam.tracker import Tracker
    rng = np.random.default_rng(seed)
    orig = Tracker.map_preprocess

    def map_preprocess(self, frame, frame_id):
        img = np.asarray(frame.image, np.float32)
        frame.image = img * (1 + rng.uniform(-1, 1, img.shape).astype(np.float32)
                             * np.float32(2.0 ** -22))
        return orig(self, frame, frame_id)

    Tracker.map_preprocess = map_preprocess


def _write_trace(log, path):
    arrays, meta = {}, {"passes": [], "poses": []}
    for i, p in enumerate(log["passes"]):
        for f, v in p["state"].items():
            arrays[f"p{i}_{f}"] = v
        meta["passes"].append({k: p[k] for k in ("time", "kind", "psnr")})
    for i, p in enumerate(log["poses"]):
        arrays[f"u{i}"] = p["poses"]
        meta["poses"].append({"time": p["time"]})
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def trace_side(a):
    """One package's traced entry-point run (``--trace``'s child process):
    ``slam.py`` in-process for ``jax``, ``slam_torch.main`` with JAX's spawn
    priorities for ``port``, on the reference's scene and child config."""
    import runpy

    with open(reference_name(a.height, a.width, a.orb, a.mp)) as f:
        ref = json.load(f)
    log = {"passes": [], "poses": []}
    sys.path.insert(0, REPO)
    os.chdir(REPO)
    with tempfile.TemporaryDirectory() as tmp:
        if a.trace_side == "jax":
            import jax

            jax.config.update("jax_platforms", "cpu")
            from rtgslam_tpu.data.synthetic import write_scene
            from rtgslam_tpu.slam import Mapper
            from rtgslam_tpu.slam.eval import eval_frame
            to_np = np.asarray
        else:
            import torch

            torch.set_num_threads(a.threads)
            from rtgslam_torch.data.synthetic import write_scene
            from rtgslam_torch.slam.eval import eval_frame
            from rtgslam_torch.slam.mapper import Mapper
            to_np = lambda t: t.detach().cpu().numpy().copy()
        _install_trace(Mapper, eval_frame, to_np, log)
        if a.perturb:
            _install_perturbation(a.trace_side, a.perturb)
        scene = write_scene(os.path.join(tmp, "scene"), ref["frames"],
                            ref["height"], ref["width"])
        cfg = write_child_config(os.path.join(tmp, "c.yaml"), ROOM_YAML, scene,
                                 os.path.join(tmp, "out"), ref["overrides"])
        if a.trace_side == "jax":
            sys.argv = ["slam.py", "--platform", "cpu", "--config", cfg]
            runpy.run_path(os.path.join(REPO, "slam.py"),
                           run_name="traced_slam")["main"]()
        else:
            import slam_torch
            from rtgslam_torch.utils.threefry import jax_priorities

            slam_torch.main(["--config", cfg, "--device", "cpu"],
                            priority_source=jax_priorities())
    os.makedirs(a.out, exist_ok=True)
    _write_trace(log, os.path.join(a.out, a.trace_side))


def _read_trace(prefix):
    with open(prefix + ".json") as f:
        meta = json.load(f)
    return meta, np.load(prefix + ".npz")


def compare_traces(a_prefix, b_prefix):
    """The per-pass table of two traces (path prefixes of
    :func:`_write_trace`'s files; each pair in a row is [a, b]): gaussian
    counts, slots whose status differs, the largest parameter gaps over the
    slots alive in both, the frames' PSNR, and the largest gap of the poses
    each run handed to ``update_poses`` up to that pass."""
    (mj, aj), (mp_, ap) = _read_trace(a_prefix), _read_trace(b_prefix)
    rows = []
    for i, (pj, pp) in enumerate(zip(mj["passes"], mp_["passes"])):
        sj, sp = aj[f"p{i}_status"], ap[f"p{i}_status"]
        both = (sj > 0) & (sp > 0)
        gap = {f: float(np.abs(aj[f"p{i}_{f}"][both] - ap[f"p{i}_{f}"][both]).max(
            initial=0.0)) for f in ("xyz", "features_dc", "opacity", "scaling")}
        poses = [k for k, u in enumerate(mj["poses"]) if u["time"] <= pj["time"]]
        pose_gap = max((float(np.abs(aj[f"u{k}"] - ap[f"u{k}"]).max())
                        for k in poses if f"u{k}" in ap), default=0.0)
        psnr_j, psnr_p = np.array(pj["psnr"]), np.array(pp["psnr"])
        rows.append({
            "pass": i, "time": pj["time"], "kind": [pj["kind"], pp["kind"]],
            "unstable": [int((sj == 1).sum()), int((sp == 1).sum())],
            "stable": [int((sj == 2).sum()), int((sp == 2).sum())],
            "status_differs": int((sj != sp).sum()), **gap,
            "pose_gap": pose_gap,
            "psnr_mean": [float(psnr_j.mean()), float(psnr_p.mean())],
            "psnr_worst_gap": float(np.abs(psnr_j - psnr_p).max()),
            "psnr_last": [float(psnr_j[-1]), float(psnr_p[-1])]})
    return rows


def compare_main(a):
    """``--compare A B``: print the per-pass table of two traces; with
    ``--table FILE --name NAME`` also store it under NAME in the JSON file
    FILE (created if absent)."""
    rows = compare_traces(*a.compare)
    for r in rows:
        print(json.dumps(r))
    if a.table:
        tables = {}
        if os.path.exists(a.table):
            with open(a.table) as f:
                tables = json.load(f)
        tables[a.name or "table"] = rows
        with open(a.table, "w") as f:
            json.dump(tables, f, indent=1)


def spread_main(a):
    """``--spread``: the final keyframe's PSNR of JAX's traced run under
    each perturbation seed, written to ``--table``."""
    import time

    procs, runs = [], []
    for seed in a.spread:
        out = os.path.join(a.out, f"jax_p{seed}")
        cmd = (f"python tests/torch_parity.py --orb --height {a.height} "
               f"--width {a.width} --trace-side jax --perturb {seed} "
               f"--out T/jax_p{seed}")
        runs.append((seed, out, cmd))
        if os.path.exists(os.path.join(out, "jax.json")):
            continue
        while sum(p.poll() is None for p in procs) >= 2:
            time.sleep(5)
        os.makedirs(out, exist_ok=True)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--orb", "--height",
             str(a.height), "--width", str(a.width), "--trace-side", "jax",
             "--perturb", str(seed), "--out", out],
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=open(os.path.join(out, "log"), "w"),
            stderr=subprocess.STDOUT))
    if any(p.wait() for p in procs):
        raise SystemExit(f"a traced run failed: see {a.out}/jax_p*/log")
    rows = []
    for seed, out, cmd in runs:
        meta, _ = _read_trace(os.path.join(out, "jax"))
        final = meta["passes"][-1]
        assert final["kind"] == "final", final["kind"]
        rows.append({"seed": seed, "final_psnr": final["psnr"][-1],
                     "command": cmd})
    psnr = [r["final_psnr"] for r in rows]
    spread = {"what": "the final keyframe's PSNR of JAX's slam.py on the TUM "
                      "keys (tests/data/entry_orb_170x300_jax_cpu.json's "
                      "scene and config), its frames' colour scaled by "
                      "1 + u 2^-22 (u from the seed; seed 0 unperturbed)",
              "host": "CPU (JAX_PLATFORMS=cpu)",
              "command": ("python tests/torch_parity.py --orb --spread "
                          + " ".join(str(r["seed"]) for r in rows)
                          + f" --out T --table {os.path.relpath(a.table, REPO)}"),
              "runs": rows, "min": min(psnr), "max": max(psnr)}
    with open(a.table, "w") as f:
        json.dump(spread, f, indent=1)
    print(json.dumps({k: spread[k] for k in ("min", "max")}))


def trace_main(a):
    """Run both traced sides as child processes at once, then print the
    per-pass table as JSON lines (and write it to ``--out``/table.json)."""
    out = a.out or tempfile.mkdtemp(prefix="trace_")
    os.makedirs(out, exist_ok=True)
    flags = [f"--{k}" for k in ("orb", "mp") if getattr(a, k)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--trace-side", side,
         "--out", out, "--height", str(a.height), "--width", str(a.width),
         "--threads", str(a.threads), "--perturb", str(a.perturb), *flags],
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        stdout=open(os.path.join(out, side + ".log"), "w"),
        stderr=subprocess.STDOUT) for side in ("jax", "port")]
    if any(p.wait() for p in procs):
        raise SystemExit(f"a traced run failed: see {out}/*.log")
    rows = compare_traces(os.path.join(out, "jax"), os.path.join(out, "port"))
    with open(os.path.join(out, "table.json"), "w") as f:
        json.dump(rows, f, indent=1)
    for r in rows:
        print(json.dumps(r))


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
    ap.add_argument("--bands", type=int, default=1,
                    help="with --entry: the row-band path, frame_bands N "
                         "(BAND_ENTRY's config at that size); with "
                         "--overflow: OVERFLOW_KEYS with frame_bands N")
    ap.add_argument("--track-stride", type=int, default=0,
                    help="with --bands: replace BAND_ENTRY's band_track_stride")
    ap.add_argument("--port", action="store_true",
                    help="run the port on the CPU against that reference "
                         "(read from --out when given) and print the gaps")
    ap.add_argument("--threads", type=int, default=3,
                    help="with --port: torch's CPU threads")
    ap.add_argument("--trace", action="store_true",
                    help="with --orb: run slam.py and the port in-process, "
                         "record the map, the frames' PSNR and the refreshed "
                         "poses after each pass, and print the per-pass table "
                         "(the traces go to --out)")
    ap.add_argument("--trace-side", choices=("jax", "port"), default=None,
                    help="with --orb: one package's traced run alone, written "
                         "to --out/<side>.json and .npz")
    ap.add_argument("--perturb", type=int, default=0,
                    help="with --trace or --trace-side: scale each frame's "
                         "colour by a rounding-size random factor from this "
                         "seed (0: off)")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None,
                    help="print the per-pass table of two traces (path "
                         "prefixes, e.g. OUT/jax and OUT/port)")
    ap.add_argument("--table", default=None,
                    help="with --compare: also store the table in this JSON file")
    ap.add_argument("--name", default=None,
                    help="with --table: the table's key in that file")
    ap.add_argument("--spread", type=int, nargs="+", default=None,
                    metavar="SEED",
                    help="with --orb: JAX's traced run under each perturbation "
                         "seed (0: none); the final keyframe's PSNR of each "
                         "to --table")
    ap.add_argument("--parallel", action="store_true",
                    help="reference of parallel/ on a 4-device CPU mesh")
    ap.add_argument("--mapper", action="store_true",
                    help="with --parallel: the slice loop with multi_device")
    ap.add_argument("--overflow", action="store_true",
                    help="reference of the lifecycle overflow count at "
                         "undersized capacities (OVERFLOW_KEYS)")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.parallel:
        # the virtual devices must be asked for before JAX starts
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count="
                                   f"{PARALLEL_SHARDS}")
        import jax

        jax.config.update("jax_platforms", "cpu")
        sys.path.insert(0, REPO)
        return (parallel_mapper_main if a.mapper else parallel_main)(a)
    if a.compare:
        return compare_main(a)
    if a.spread:
        if not (a.out and a.table):
            ap.error("--spread needs --out and --table")
        return spread_main(a)
    if a.trace_side:
        if not a.out:
            ap.error("--trace-side needs --out")
        return trace_side(a)
    if a.trace:
        return trace_main(a)
    if a.port:
        return port_main(a)

    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    if a.entry or a.mp:
        return entry_main(a)
    if a.overflow:
        return overflow_main(a)
    out_path = a.out or slice_reference(a.height, a.width, a.optimize)
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
