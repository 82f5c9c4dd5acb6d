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


class Mapper:
    """The mapper on ``device`` (CUDA unless the caller asks for the CPU)."""

    def __init__(self, args, device="cuda",
                 priority_source: Optional[PrioritySource] = None):
        if bool(getattr(args, "multi_device", False)):
            raise NotImplementedError(
                "multi_device=True is not ported: the JAX package's mesh "
                "(parallel/) is under ROADMAP.md's \"Do not port\"")
        self.args = args
        self.device = setup_device(require_device(device))
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
        # run-wide high-water mark of render bin overflow (all renders)
        self.max_overflow = 0

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

    def _note_overflow(self, out) -> None:
        self.max_overflow = max(self.max_overflow, int(out["overflow"]))

    def _render(self, camera: Dict[str, torch.Tensor],
                settings: Optional[RasterSettings] = None):
        """Render every alive gaussian (the JAX ``_render(.., "global")``),
        with the mapper's settings unless ``settings`` overrides them."""
        out = render(render_inputs(self.state, alive_mask(self.state)),
                     camera, settings or self.settings)
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
        n, model_out = map_ops.spawn_chain(
            self._next_priorities(), self.state, self.frame_map,
            frame.device_dict(self.device), self.time, self._spawn_args(),
            self.config, self.max_spawn, self.settings,
            first_frame=self.time == 0, has_stable=self.get_stable_num > 0)
        if model_out is not None:
            self._note_overflow(model_out)
            self._set_model_map(model_out)
        return n

    def _mapping_fused_frame(self, frame: Camera):
        """Non-optimize frame: spawn + lifecycle (``:306``)."""
        n, model_out, out = map_ops.frame_chain(
            self._next_priorities(), self.state, self.frame_map,
            frame.device_dict(self.device), self.time, self._spawn_args(),
            self._lifecycle_args(), self.config, self.max_spawn,
            self.settings, has_stable=self.get_stable_num > 0)
        self._note_overflow(model_out)
        self._note_overflow(out)
        self._set_model_map(model_out)
        self._cache_render(out, (self.time, frame.uid))
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
        prep = optimize.optimize_prepare(self.state, *stacked, self.settings,
                                         mode, sample_ratio, mdp)
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
        ``memory_length`` by repeating the newest frame."""
        entries = [self._entry(rec["camera"], rec["frame_map"]["color_map"],
                               rec["frame_map"]["depth_map"],
                               rec["frame_map"]["normal_map_w"])
                   for rec in self.processed_frames]
        n_actual = len(entries)
        entries += [entries[-1]] * (self.memory_length - n_actual)
        n_iters = self.gaussian_update_iter
        return self._optimize(entries, self._iteration_frames(n_actual, n_iters),
                              n_iters, self._lrs(opt), self._weights(opt),
                              "local", -1.0, self.history_merge_max_weight)

    def global_optimization(self, opt, select_keyframe_num: int = -1):
        """Stable-map refinement over the newest keyframes; the final pass
        (``select_keyframe_num == -1``) fixes every gaussian and sweeps all
        keyframes in a shuffled order, ``final_global_iter`` iterations each
        (``global_optimization`` :626)."""
        is_final = select_keyframe_num == -1
        if is_final:
            map_ops.fix_all(self.state)
        if self.get_stable_num == 0:
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
            entries += [entries[-1]] * (self.global_keyframe_num - n_actual)
            n_iters = self.gaussian_update_iter
            return self._optimize(
                entries, self._iteration_frames(n_actual, n_iters), n_iters,
                lrs, weights, "global",
                float(getattr(self.args, "global_opt_top_ratio", 0.4)), 0.0)
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
        out = map_ops.lifecycle_chain(
            self.state, rec["camera"].device_dict(self.device),
            fm["color_map"], fm["depth_map"], self._lifecycle_args(),
            self.settings)
        self._note_overflow(out)
        self._cache_render(out, (self.time, rec["camera"].uid))

    def _cache_render(self, out, key) -> None:
        self._cached_render = out
        self._cached_render_key = key

    # ------------------------------------------------------------------
    # top-level per-frame entry
    # ------------------------------------------------------------------
    def mapping(self, frame: Camera, frame_map: Dict, frame_id: int,
                opt) -> None:
        """Map one tracked frame (``mapping`` :793); ``opt`` holds the
        optimization weights and learning rates (``OptimizationParams``)."""
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
            if not is_keyframe or self.get_stable_num <= 0:
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
