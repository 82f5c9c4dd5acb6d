"""Mapping back-end: incremental Gaussian map construction + optimization.

Port of ``rtgslam_tpu/slam/mapper.py``.  Per mapped frame (reference
``SLAM/multiprocess/mapper.py``):

  gaussians_add        three-type spawning (newly observed / depth-error /
                       color-error pixels) -> dedup -> stable-attach -> KNN
                       scale init -> insert into free slots, with the
                       model/stable renders
  local_optimize       gradient optimization of the unstable pool over the
                       recent-frame memory, then the history merge
  global_optimization  keyframe-window refinement of the stable pool; at the
                       end of the run, the final pass over every keyframe
  lifecycle            fix confident -> error strikes -> delete, with its render
  save_model /         PLY checkpoints in the JAX package's layout and bytes
  load_model

Optimization frames (every ``gaussian_update_frame``-th) run these as
separate steps; the others run ``map_ops.frame_chain``.  The gradient passes
run through ``models/optimize.py`` (the blend kernels K1 and K2).

With a mesh (:func:`mapper_mesh`, or the ``mesh`` argument) the standalone
renders go tile-sharded (``parallel/sp_render.py``) and the local and
windowed global passes frame-parallel (``parallel/sharded.py``), as the JAX
mapper's ``multi_device`` branches do; the final pass stays on one device.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import setup_device
from ..data.camera import Camera
from ..models import map_ops, optimize
from ..models.gaussian_map import (STABLE, UNSTABLE, GaussianMapConfig,
                                   MapState, alive_mask, load_numpy_dict,
                                   render_inputs, to_numpy_dict)
from ..ops.rasterize import RasterSettings, render
from ..parallel import (dp_global_optimize, dp_local_optimize, make_mesh,
                        sp_render)
from ..parallel.mesh import Mesh
from ..utils import perf
from ..utils import ply as ply_utils
from ..utils.general import require_device
from ..utils.geometry import rot_compare, trans_compare

PrioritySource = Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]


def generator_priorities(device, seed: int = 2024) -> PrioritySource:
    """The default spawn priority source: a ``torch.Generator`` on
    ``device``, seeded once; each call returns two fresh [n] uniform
    vectors (the JAX mapper splits ``PRNGKey(2024)`` per spawn instead —
    the numbers differ, the distribution does not)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(spawn_index: int, n: int):
        return (torch.rand(n, generator=gen, device=device),
                torch.rand(n, generator=gen, device=device))

    return draw


def mapper_mesh(args, device: torch.device) -> Optional[Mesh]:
    """The JAX mapper's rule (mapper.py:113-116): with ``multi_device`` set
    and more than one CUDA device visible, a mesh over all of them; else
    None, and the one-device path."""
    if bool(getattr(args, "multi_device", False)) and device.type == "cuda" \
            and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


class Mapper:
    """The mapper on ``device`` (CUDA unless the caller asks for the CPU).
    ``mesh`` gives the sharded paths a mesh of the caller's choosing (the
    tests' and chip_smoke's virtual shards of one device); by default it is
    :func:`mapper_mesh`'s."""

    def __init__(self, args, device="cuda",
                 priority_source: Optional[PrioritySource] = None,
                 mesh: Optional[Mesh] = None):
        self.args = args
        self.device = setup_device(require_device(device))
        self.mesh = mesh if mesh is not None else mapper_mesh(args, self.device)
        self.config = GaussianMapConfig.from_args(args)
        self.state = MapState.create(self.config, self.device)
        self.priorities = priority_source or generator_priorities(self.device)
        self.n_spawns = 0

        self.time = 0
        self.iter = 0      # the checkpoint names' iteration stamp, as in JAX
        self.save_path = args.save_path
        self.save_step = int(args.save_step)
        self.gaussian_update_iter = int(args.gaussian_update_iter)
        self.final_global_iter = int(args.final_global_iter)
        self.freeze_binning = bool(getattr(args, "optimize_freeze_binning", False))
        # the compact two-stage path supersedes freeze_binning when on
        self.optimize_compact = bool(getattr(args, "optimize_compact", False))
        self.gaussian_update_frame = int(args.gaussian_update_frame)
        self.memory_length = int(args.memory_length)
        self.global_keyframe_num = int(args.global_keyframe_num)
        self.keyframe_trans_thes = float(args.keyframe_trans_thes)
        self.keyframe_theta_thes = float(args.keyframe_theta_thes)
        self.history_merge_max_weight = float(args.history_merge_max_weight)
        self.dataset_type = getattr(args, "type", "Replica")
        self.feature_lr_coef = float(getattr(args, "feature_lr_coef", 1.0))
        self.scaling_lr_coef = float(getattr(args, "scaling_lr_coef", 1.0))
        self.rotation_lr_coef = float(getattr(args, "rotation_lr_coef", 1.0))
        # the JAX mapper's numpy stream (mapper.py:118): the iterations'
        # frame sequences and the final pass's keyframe order
        self.rng = np.random.default_rng(2024)

        self.uniform_sample_num = int(args.uniform_sample_num)
        self.add_depth_thres = float(args.add_depth_thres)
        self.add_color_thres = float(args.add_color_thres)
        self.add_transmission_thres = float(args.add_transmission_thres)
        self.transmission_sample_ratio = float(args.transmission_sample_ratio)
        self.error_sample_ratio = float(args.error_sample_ratio)
        self.stable_confidence_thres = float(args.stable_confidence_thres)
        self.unstable_time_window = float(args.unstable_time_window)
        self.max_spawn = self.config.temp_capacity // 2

        self.processed_frames: deque = deque(maxlen=self.memory_length)
        self.keyframe_list: List[Dict] = []
        self.optimize_frames_ids: List[int] = []   # frames that ran a pass
        self.settings: Optional[RasterSettings] = None
        self.model_map: Dict[str, torch.Tensor] = {}
        self.frame_map: Dict[str, torch.Tensor] = {}
        self._cached_render = None
        self._cached_render_key = None
        # run-wide high-water mark of render bin overflow: every render at
        # the mapper's raster, and apart from them the row-band step's
        # feedback renders at the tracker's (slam/run.py)
        self.max_overflow = 0
        self.max_feedback_overflow = 0
        # the JAX mapper's count (its ``max_overflow``, :127): the lifecycle
        # renders only, each folded in when the next spawn or frame chain
        # starts (``_cached_hwm`` :217), so the newest stays pending until
        # then or ``fold_overflow``
        self.lifecycle_overflow = 0
        self._pending_overflow: Optional[int] = None

        # TensorBoard scalars in single-process mode (``tb_writer`` :131,
        # reference mapper.py:928-931,968-980); none where
        # torch.utils.tensorboard is not installed, as in the JAX package
        self.tb_writer = None
        if bool(getattr(args, "use_tensorboard", False)) and \
                getattr(args, "mode", "single process") == "single process":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self.tb_writer = SummaryWriter(self.save_path)

    def train_report(self, iteration: int, losses: Dict[str, torch.Tensor]) -> None:
        if self.tb_writer is not None:
            for k, v in losses.items():
                self.tb_writer.add_scalar(f"train/{k}", float(v), iteration)

    def eval_report(self, iteration: int, metrics: Dict[str, float]) -> None:
        if self.tb_writer is not None:
            for k, v in metrics.items():
                self.tb_writer.add_scalar(f"eval/{k}", float(v), iteration)

    # ------------------------------------------------------------------
    def _ensure_settings(self, frame: Camera):
        if self.settings is None:
            self.settings = RasterSettings.from_args(
                self.args, frame.image_height, frame.image_width)

    @property
    def get_unstable_num(self) -> int:
        return int((self.state.status == UNSTABLE).sum())

    @property
    def get_stable_num(self) -> int:
        return int((self.state.status == STABLE).sum())

    @property
    def get_total_iter(self) -> int:
        return self.iter + self.time * self.gaussian_update_iter

    def _has_stable(self) -> bool:
        with perf.span("map.stable_fetch"):
            return self.get_stable_num > 0

    def _note_overflow(self, out) -> int:
        with perf.span("map.overflow_fetch"):
            overflow = int(out["overflow"])
        self.max_overflow = max(self.max_overflow, overflow)
        return overflow

    def fold_overflow(self) -> None:
        """Fold the newest lifecycle render's overflow into
        ``lifecycle_overflow`` (what ``_cached_hwm`` :217-222 does, and
        ``tests/test_slam_e2e.py`` by hand after a run)."""
        if self._pending_overflow is not None:
            self.lifecycle_overflow = max(self.lifecycle_overflow,
                                          self._pending_overflow)
            self._pending_overflow = None

    def _render(self, camera: Dict[str, torch.Tensor],
                settings: Optional[RasterSettings] = None,
                feedback: bool = False):
        """Render every alive gaussian (the JAX ``_render(.., "global")``),
        with the mapper's settings unless ``settings`` overrides them;
        tile-sharded over the mesh when there is one (:179-184).  A
        ``feedback`` render (the tracker's model at its own raster) counts
        its overflow in ``max_feedback_overflow``, not ``max_overflow``."""
        gauss = render_inputs(self.state, alive_mask(self.state))
        if self.mesh is not None:
            out = sp_render(gauss, camera, settings or self.settings, self.mesh)
        else:
            out = render(gauss, camera, settings or self.settings)
        if feedback:
            with perf.span("map.overflow_fetch"):
                overflow = int(out["overflow"])
            self.max_feedback_overflow = max(self.max_feedback_overflow,
                                             overflow)
        else:
            self._note_overflow(out)
        return out

    def get_render_output(self, frame: Camera):
        """Global render for the model map; reuses this frame's lifecycle
        render (``get_render_output`` :188)."""
        if self._cached_render is not None \
                and self._cached_render_key == (self.time, frame.uid):
            out = self._cached_render
        else:
            out = self._render(frame.device_dict(self.device))
        self._set_model_map(out)
        return out

    def _set_model_map(self, out):
        self.model_map = {
            "render_color": out["render"],
            "render_depth": out["depth"],
            "render_normal": out["normal"],
            "render_color_index": out["color_index_map"],
            "render_depth_index": out["depth_index_map"],
            "render_transmission": out["T_map"],
        }

    # ------------------------------------------------------------------
    # spawning
    # ------------------------------------------------------------------
    def _next_priorities(self):
        n = self.settings.height * self.settings.width
        pa, pb = self.priorities(self.n_spawns, n)
        self.n_spawns += 1
        return (torch.as_tensor(pa, dtype=torch.float32, device=self.device),
                torch.as_tensor(pb, dtype=torch.float32, device=self.device))

    def _spawn_args(self) -> dict:
        return dict(
            uniform_sample_num=self.uniform_sample_num,
            transmission_sample_ratio=self.transmission_sample_ratio,
            error_sample_ratio=self.error_sample_ratio,
            add_transmission_thres=self.add_transmission_thres,
            add_depth_thres=self.add_depth_thres,
            add_color_thres=self.add_color_thres)

    def _lifecycle_args(self) -> tuple:
        return (self.stable_confidence_thres, self.add_color_thres,
                self.add_depth_thres, self.time, self.unstable_time_window)

    def gaussians_add(self, frame: Camera):
        """Three-type spawning with its model/stable renders
        (``gaussians_add`` :228, reference mapper.py:128-132,728,849)."""
        self.fold_overflow()
        with perf.span("map.counter_fetch"):
            has_stable = self.get_stable_num > 0
        with perf.span("map.spawn_chain"):
            n, model_out = map_ops.spawn_chain(
                self._next_priorities(), self.state, self.frame_map,
                frame.device_dict(self.device), self.time, self._spawn_args(),
                self.config, self.max_spawn, self.settings,
                first_frame=self.time == 0, has_stable=has_stable)
        if model_out is not None:
            self._note_overflow(model_out)
            self._set_model_map(model_out)
        return n

    def _mapping_fused_frame(self, frame: Camera):
        """Non-optimize frame: spawn + lifecycle (``:306``)."""
        self.fold_overflow()
        with perf.span("map.counter_fetch"):
            has_stable = self.get_stable_num > 0
        with perf.span("map.frame_chain"):
            n, model_out, out = map_ops.frame_chain(
                self._next_priorities(), self.state, self.frame_map,
                frame.device_dict(self.device), self.time, self._spawn_args(),
                self._lifecycle_args(), self.config, self.max_spawn,
                self.settings, has_stable=has_stable)
        self._note_overflow(model_out)
        self._set_model_map(model_out)
        self._cache_render(out, (self.time, frame.uid), self._note_overflow(out))
        return n

    # ------------------------------------------------------------------
    # keyframes
    # ------------------------------------------------------------------
    def _keyframe_predicate(self, frame: Camera) -> bool:
        """Rotation / translation threshold test (reference mapper.py:336-368)."""
        if self.time == 0:
            return True
        prev = self.keyframe_list[-1]["frame"]
        _, theta_diff = rot_compare(prev.R.T, frame.R.T)
        _, l2_diff = trans_compare(prev.T, frame.T)
        return (theta_diff > self.keyframe_theta_thes
                or l2_diff > self.keyframe_trans_thes)

    def check_keyframe(self, frame: Camera, frame_id: int) -> bool:
        """Record a keyframe with the maps the global passes optimize
        against; True for every keyframe but the first (``check_keyframe``
        :373)."""
        is_first = self.time == 0
        if not self._keyframe_predicate(frame):
            return False
        fm = self.frame_map
        self.keyframe_list.append({
            "frame": frame.drop_images(), "frame_id": frame_id,
            "map": {"color_map": fm["color_map"], "depth_map": fm["depth_map"],
                    "normal_map": fm["normal_map_w"]}})
        return not is_first

    def update_poses(self, new_poses) -> None:
        """Re-apply refined historical poses (``update_poses`` :392)."""
        if new_poses is None:
            return
        for entry in self.processed_frames:
            entry["camera"].update_pose(new_poses[entry["camera"].uid])
        for kf in self.keyframe_list:
            if kf["frame"].uid < len(new_poses):
                kf["frame"].update_pose(new_poses[kf["frame"].uid])

    # ------------------------------------------------------------------
    # optimization
    # ------------------------------------------------------------------
    @staticmethod
    def _lrs(opt, scale_overrides=None) -> Dict[str, float]:
        """Per-group learning rates (``_lrs`` :407); a negative override
        means 0."""
        lrs = {
            "xyz": opt.position_lr,
            "features_dc": opt.feature_lr,
            "features_rest": opt.feature_lr / 20.0,
            "opacity": opt.opacity_lr,
            "scaling": opt.scaling_lr,
            "rotation": opt.rotation_lr,
        }
        for k, s in (scale_overrides or {}).items():
            lrs[k] = lrs[k] * s if s >= 0 else 0.0
        return lrs

    def _weights(self, opt, depth_weight=None) -> Dict[str, float]:
        """Loss weights and the depth-loss threshold (``_weights`` :421)."""
        return {
            "color_weight": opt.color_weight,
            "depth_weight": (opt.depth_weight if depth_weight is None
                             else depth_weight),
            "normal_weight": opt.normal_weight,
            "add_depth_thres": self.add_depth_thres,
        }

    @staticmethod
    def _stack_entries(entries):
        return tuple(torch.stack([e[k] for e in entries])
                     for k in ("color", "depth", "normal", "w2c", "K",
                               "campos"))

    def _entry(self, camera: Camera, color, depth, normal):
        cam = camera.device_dict(self.device)
        return {"color": color, "depth": depth[..., 0], "normal": normal,
                "w2c": cam["w2c"], "K": cam["K"], "campos": cam["campos"]}

    def _mesh_entries(self, entries, n_actual: int):
        """One entry per shard: ``entries`` cycled as the JAX mapper does
        (``entries[len % n_actual]``), then the first ``mesh.size``."""
        entries = list(entries)
        while len(entries) < self.mesh.size:
            entries.append(entries[len(entries) % n_actual])
        return entries[:self.mesh.size]

    def _iteration_frames(self, n_actual: int, n_iters: int) -> np.ndarray:
        """Random frame per iteration, the newest in the late half
        (mapper.py:604-605)."""
        seq = self.rng.integers(0, n_actual, size=n_iters)
        seq[n_iters // 2 + 1:] = n_actual - 1
        return seq

    def _optimize(self, entries, seq, n_iters: int, lrs, weights, mode: str,
                  sample_ratio: float, max_weight: float):
        """One windowed pass: the compact two-stage path
        (``_optimize_compact`` :485) or, with ``optimize_compact`` off, full
        renders every iteration (``optimize_chain``)."""
        stacked = self._stack_entries(entries)
        mdp = self.dataset_type == "Scannetpp"
        if not self.optimize_compact:
            return optimize.optimize_chain(
                self.state, *stacked, seq, n_iters, lrs, weights,
                self.settings, mode, sample_ratio, mdp, max_weight,
                self.freeze_binning)
        with perf.span("optimize.prepare"):
            prep = optimize.optimize_prepare(self.state, *stacked,
                                             self.settings, mode, sample_ratio,
                                             mdp)
        Ac = max(prep.n_pool, 1)
        Tc = max(prep.n_live_tiles, 1)
        return optimize.optimize_execute(
            self.state, *stacked, prep.rmasks, prep.lists_orig, prep.counts,
            prep.pool_order[:Ac], prep.n_pool, prep.tile_order[:, :Tc], seq,
            n_iters, lrs, weights, self.settings, mode, max_weight,
            optimize.list_crop(prep.cnt_max, prep.lists_orig.shape[-1]))

    def local_optimize(self, frame: Camera, opt):
        """Optimize the unstable pool over the frame memory, then merge it
        with its history (``local_optimize`` :567).  The memory is padded to
        ``memory_length`` by repeating the newest frame.  On a mesh each
        shard takes one of the newest entries of that padded memory, which
        is cycled when it holds fewer entries than shards (:585-603)."""
        entries = [self._entry(rec["camera"], rec["frame_map"]["color_map"],
                               rec["frame_map"]["depth_map"],
                               rec["frame_map"]["normal_map_w"])
                   for rec in self.processed_frames]
        n_actual = len(entries)
        entries += [entries[-1]] * (self.memory_length - n_actual)
        n_iters = self.gaussian_update_iter
        with perf.span("map.local_optimize"):
            if self.mesh is not None:
                entries = self._mesh_entries(entries[-self.mesh.size:], n_actual)
                report = {"total": dp_local_optimize(
                    self.state, *self._stack_entries(entries), n_iters,
                    self._lrs(opt), self._weights(opt), self.settings,
                    self.mesh, self.dataset_type == "Scannetpp",
                    self.history_merge_max_weight)}
            else:
                report = self._optimize(
                    entries, self._iteration_frames(n_actual, n_iters),
                    n_iters, self._lrs(opt), self._weights(opt), "local",
                    -1.0, self.history_merge_max_weight)
        self.train_report(self.get_total_iter, report)
        return report

    def global_optimization(self, opt, select_keyframe_num: int = -1):
        """Stable-map refinement over the newest keyframes; the final pass
        (``select_keyframe_num == -1``) fixes every gaussian and sweeps all
        keyframes in a shuffled order, ``final_global_iter`` iterations each
        (``global_optimization`` :626)."""
        is_final = select_keyframe_num == -1
        if is_final:
            map_ops.fix_all(self.state)
        if not self._has_stable():
            return None
        if is_final:
            lrs = self._lrs(opt, {
                "xyz": -1,
                "features_dc": self.feature_lr_coef,
                "features_rest": self.feature_lr_coef,
                "scaling": self.scaling_lr_coef,
                "rotation": self.rotation_lr_coef,
            })
            depth_weight = 0.0
            select_keyframe_num = len(self.keyframe_list)
        else:
            lrs = self._lrs(opt, {k: 0.1 for k in
                                  ("features_dc", "features_rest", "opacity",
                                   "scaling", "rotation")})
            lrs["xyz"] = 0.0
            depth_weight = None
        select_keyframe_num = min(select_keyframe_num, len(self.keyframe_list))
        weights = self._weights(opt, depth_weight=depth_weight)
        # newest first (mapper.py:647-649)
        selected = [self.keyframe_list[-(i + 1)]
                    for i in range(select_keyframe_num)]

        def make_entry(kf):
            m = kf["map"]
            return self._entry(kf["frame"], m["color_map"], m["depth_map"],
                               m["normal_map"])

        if not is_final:
            entries = [make_entry(kf) for kf in selected]
            n_actual = len(entries)
            n_iters = self.gaussian_update_iter
            ratio = float(getattr(self.args, "global_opt_top_ratio", 0.4))
            with perf.span("map.global_optimize"):
                if self.mesh is not None:
                    # one keyframe per shard, cycled (:679-692)
                    entries = self._mesh_entries(entries, n_actual)
                    return {"total": dp_global_optimize(
                        self.state, *self._stack_entries(entries), n_iters,
                        lrs, weights, self.settings, self.mesh, ratio,
                        self.dataset_type == "Scannetpp")}
                entries += [entries[-1]] * (self.global_keyframe_num - n_actual)
                return self._optimize(
                    entries, self._iteration_frames(n_actual, n_iters), n_iters,
                    lrs, weights, "global", ratio, 0.0)
        report = None
        for kf_idx in self.rng.permutation(select_keyframe_num):
            n_iters = self.final_global_iter
            report = optimize.optimize_chain(
                self.state, *self._stack_entries(
                    [make_entry(selected[int(kf_idx)])]),
                np.zeros(n_iters, np.int64), n_iters, lrs, weights,
                self.settings, "global", -1.0,
                self.dataset_type == "Scannetpp", 0.0, self.freeze_binning)
        return report

    # ------------------------------------------------------------------
    # error-driven self-healing
    # ------------------------------------------------------------------
    def lifecycle(self):
        """fix -> error strikes -> unstable delete with its render
        (``lifecycle`` :731)."""
        rec = self.processed_frames[-1]
        fm = rec["frame_map"]
        with perf.span("map.lifecycle_chain"):
            out = map_ops.lifecycle_chain(
                self.state, rec["camera"].device_dict(self.device),
                fm["color_map"], fm["depth_map"], self._lifecycle_args(),
                self.settings)
        self._cache_render(out, (self.time, rec["camera"].uid),
                           self._note_overflow(out))

    def _cache_render(self, out, key, overflow: int) -> None:
        """Keep this frame's lifecycle render and hold its overflow until
        the next fold (``_cache_render`` :773)."""
        self._cached_render = out
        self._cached_render_key = key
        self._pending_overflow = overflow

    # ------------------------------------------------------------------
    # top-level per-frame entry
    # ------------------------------------------------------------------
    def mapping(self, frame: Camera, frame_map: Dict, frame_id: int,
                opt) -> None:
        """Map one tracked frame (``mapping`` :793); ``opt`` holds the
        optimization weights and learning rates (``OptimizationParams``)."""
        with perf.span("map.frame"):
            self._mapping(frame, frame_map, frame_id, opt)

    def _mapping(self, frame: Camera, frame_map: Dict, frame_id: int,
                 opt) -> None:
        self._ensure_settings(frame)
        self.frame_map = frame_map
        optimize_frame = ((self.time + 1) % self.gaussian_update_frame == 0
                          or self.time == 0)
        record = {"camera": frame.drop_images(), "frame_map": frame_map}
        if not optimize_frame:
            self._mapping_fused_frame(frame)
            self.processed_frames.append(record)
            return
        self.gaussians_add(frame)
        self.processed_frames.append(record)
        self.optimize_frames_ids.append(frame_id)

        is_keyframe = self.check_keyframe(frame, frame_id)
        if self.dataset_type == "Scannetpp":
            self.local_optimize(frame, opt)
            if is_keyframe:
                self.global_optimization(opt, self.global_keyframe_num)
        else:
            if not is_keyframe or not self._has_stable():
                self.local_optimize(frame, opt)
            else:
                self.global_optimization(opt, self.global_keyframe_num)
            map_ops.delete_gaussians(self.state, self.time,
                                     self.unstable_time_window, unstable=False)
        self.lifecycle()

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def snapshot_host(self):
        """Host copy of both pools' PLY rows and the (time, iter) stamp
        (``snapshot_host`` :838)."""
        return {"unstable": to_numpy_dict(self.state, UNSTABLE),
                "stable": to_numpy_dict(self.state, STABLE),
                "time": self.time, "iter": self.iter}

    def save_snapshot(self, snap, path=None, save_data=True, save_sibr=True,
                      save_merge=True):
        """Write one host snapshot as PLYs in the reference layout
        (``save_model/frame_*/iter_*[.ply|_stable.ply|_sibr.ply|_merge.ply]``,
        ``save_snapshot`` :851, reference mapper.py:933-966)."""
        if path is None:
            model_dir = os.path.join(self.save_path, "save_model",
                                     f"frame_{snap['time']:04d}")
            os.makedirs(model_dir, exist_ok=True)
            path = os.path.join(model_dir, f"iter_{snap['iter']:04d}")

        def dump(pool, suffix, confidence):
            data = snap[pool]
            if data["xyz"].shape[0] == 0:
                return False
            ply_utils.save_gaussian_ply(
                path + suffix, data["xyz"], data["features_dc"],
                data["features_rest"], data["opacity"], data["scaling"],
                data["rotation"],
                data["confidence"] if confidence else None)
            return True

        has_u = has_s = False
        if save_data:
            has_u = dump("unstable", ".ply", True)
            has_s = dump("stable", "_stable.ply", True)
        if save_sibr:
            dump("unstable", "_sibr.ply", False)
            dump("stable", "_stable_sibr.ply", False)
        if has_u and has_s and save_merge:
            ply_utils.merge_gaussian_ply(
                path + ".ply", path + "_stable.ply", path + "_merge.ply")

    def save_model(self, path=None, save_data=True, save_sibr=True, save_merge=True):
        """PLY snapshots in the reference layout (``save_model`` :884)."""
        self.save_snapshot(self.snapshot_host(), path=path,
                           save_data=save_data, save_sibr=save_sibr,
                           save_merge=save_merge)

    def load_model(self, ply_path: str):
        """Load a checkpoint into the stable pool of an empty map
        (``load_model`` :890, the metric.py:154 contract)."""
        data = ply_utils.read_gaussian_ply(ply_path)
        self.state = load_numpy_dict(MapState.create(self.config, self.device),
                                     data, STABLE)
