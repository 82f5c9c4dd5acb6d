"""Mapping back-end: incremental Gaussian map construction.

Port of ``rtgslam_tpu/slam/mapper.py`` for the forward slice, i.e. with no
gradient map optimization.  Per mapped frame (reference
``SLAM/multiprocess/mapper.py``):

  gaussians_add   three-type spawning (newly observed / depth-error /
                  color-error pixels) -> dedup -> stable-attach -> KNN scale
                  init -> insert into free slots, with the model/stable renders
  local_optimize  at zero iterations: the history merge of the unstable rows
  lifecycle       fix confident -> error strikes -> delete, with its render

Optimization frames (every ``gaussian_update_frame``-th) run these as
separate steps; the others run ``map_ops.frame_chain``.  Gradient map
optimization comes with the backward blend kernel: until then any
iteration count above 0 is refused.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import setup_device
from ..data.camera import Camera
from ..models import map_ops
from ..models.gaussian_map import (STABLE, UNSTABLE, GaussianMapConfig,
                                   MapState, alive_mask, render_inputs,
                                   unstable_mask)
from ..ops.rasterize import RasterSettings, render
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
    def __init__(self, args, device="cpu",
                 priority_source: Optional[PrioritySource] = None):
        for name in ("gaussian_update_iter", "final_global_iter"):
            if int(getattr(args, name)) > 0:
                raise NotImplementedError(
                    f"{name}={getattr(args, name)}: gradient optimization is "
                    "ported with the backward blend kernel")
        self.args = args
        self.device = setup_device(device)
        self.config = GaussianMapConfig.from_args(args)
        self.state = MapState.create(self.config, self.device)
        self.priorities = priority_source or generator_priorities(self.device)
        self.n_spawns = 0

        self.time = 0
        self.gaussian_update_frame = int(args.gaussian_update_frame)
        self.memory_length = int(args.memory_length)
        self.global_keyframe_num = int(args.global_keyframe_num)
        self.keyframe_trans_thes = float(args.keyframe_trans_thes)
        self.keyframe_theta_thes = float(args.keyframe_theta_thes)
        self.history_merge_max_weight = float(args.history_merge_max_weight)
        self.dataset_type = getattr(args, "type", "Replica")

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

    def _render(self, camera: Dict[str, torch.Tensor]):
        """Render every alive gaussian (the JAX ``_render(.., "global")``)."""
        out = render(render_inputs(self.state, alive_mask(self.state)),
                     camera, self.settings)
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
        """Record a keyframe; True for every keyframe but the first
        (``check_keyframe`` :373).  The keyframe's maps, which only the
        gradient passes read, are not kept yet."""
        is_first = self.time == 0
        if not self._keyframe_predicate(frame):
            return False
        self.keyframe_list.append({"frame": frame.drop_images(),
                                   "frame_id": frame_id})
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
    # optimization at zero iterations
    # ------------------------------------------------------------------
    def local_optimize(self, frame: Camera):
        """What the JAX local pass runs at ``gaussian_update_iter == 0``
        (``optimize_execute`` :570-581): the history merge of the unstable
        rows against a snapshot of the unchanged state."""
        map_ops.history_merge(self.state, map_ops.capture_history(self.state),
                              self.history_merge_max_weight,
                              unstable_mask(self.state))

    def global_optimization(self, select_keyframe_num: int = -1):
        """Keyframe-window or final global pass (``global_optimization``
        :626).  At ``gaussian_update_iter == 0`` the windowed pass changes
        nothing; at ``final_global_iter == 0`` the final pass is ``fix_all``."""
        if select_keyframe_num == -1:
            map_ops.fix_all(self.state)

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
    def mapping(self, frame: Camera, frame_map: Dict, frame_id: int) -> None:
        """Map one tracked frame (``mapping`` :793)."""
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

        is_keyframe = self.check_keyframe(frame, frame_id)
        if self.dataset_type == "Scannetpp":
            self.local_optimize(frame)
            if is_keyframe:
                self.global_optimization(self.global_keyframe_num)
        else:
            if not is_keyframe or self.get_stable_num <= 0:
                self.local_optimize(frame)
            else:
                self.global_optimization(self.global_keyframe_num)
            map_ops.delete_gaussians(self.state, self.time,
                                     self.unstable_time_window, unstable=False)
        self.lifecycle()
