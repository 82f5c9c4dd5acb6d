"""Parameter groups: defaults and extraction from a resolved config.

Copy of ``rtgslam_tpu/config/params.py`` (``DatasetParams`` :46,
``OptimizationParams`` :74, ``MapParams`` :93; reference
``arguments/__init__.py``), so the port runs without the JAX package.
Each group declares its defaults as attributes; ``extract`` projects a
resolved config namespace onto the keys the group owns (a leading
underscore marks a key that the reference also gives a one-letter flag).
The config's values, not the defaults below, reach the program.  The
port registers no command-line flags from these groups.
"""

from __future__ import annotations

import os
from typing import Any

from .loader import GroupParams


class ParamGroup:
    def extract(self, args: Any) -> GroupParams:
        group = GroupParams()
        own = vars(self)
        for key, value in vars(args).items():
            if key in own or ("_" + key) in own:
                setattr(group, key, value)
        return group


class DatasetParams(ParamGroup):
    """Dataset loading knobs (reference ``arguments/__init__.py:121-146``)."""

    def __init__(self):
        self._source_path = ""
        self._model_path = ""
        self._images = "images"
        self._resolution = -1
        self._white_background = False
        self.type = "ours"
        self.data_device = "cuda"
        self.eval = False
        self.init_mode = "random"
        self.frame_num = -1
        self.frame_start = 0
        self.frame_step = 0
        self.eval_llff = 8
        self.sh_degree = 3
        self.preload = False
        self.resolution_scales = [1.0]

    def extract(self, args):
        g = super().extract(args)
        g.source_path = os.path.abspath(g.source_path)
        return g


class OptimizationParams(ParamGroup):
    """Per-iteration optimization weights/lrs (reference ``arguments/__init__.py:104-120``)."""

    def __init__(self):
        self.train_iterations = 30_000
        self.position_lr = 0.0016
        self.feature_lr = 0.0025
        self.opacity_lr = 0.05
        self.scaling_lr = 0.005
        self.rotation_lr = 0.001

        self.color_weight = 0.8
        self.depth_weight = 1.0
        self.ssim_weight = 0.2
        self.history_weight = 0.1
        self.normal_weight = 0.1


class MapParams(ParamGroup):
    """Gaussian-map management knobs (reference ``arguments/__init__.py:147-214``).

    Additions of the JAX package, kept: ``map_capacity`` (slot count of the
    map), ``temp_capacity`` (per-frame spawn staging), ``tile_capacity`` /
    ``block_capacity`` (binning capacities).  They bound sizes; they are
    capacities, not behaviour changes.
    """

    def __init__(self):
        self.init_opacity = 0.999
        self.max_sh_degree = 4
        self.active_sh_degree = -1
        self.uniform_sample_num = 5000
        self.gaussian_update_iter = 300
        self.gaussian_update_frame = 1
        self.KNN_num = 15
        self.KNN_threshold = 0.005

        self.spatial_lr_scale = 1
        self.save_path = "output/slam_test"
        self.min_depth = 0.0
        self.max_depth = 0.0
        self.renderer_opaque_threshold = 0.7
        self.renderer_normal_threshold = 80
        self.renderer_depth_threshold = 1.0
        self.render_mode = "ours"

        self.memory_length = 10
        self.xyz_factor = [1, 1, 1]
        self.use_tensorboard = True
        self.add_depth_thres = 0.05
        self.add_normal_thres = 0.1
        self.add_color_thres = 0.1
        self.add_transmission_thres = 0.1
        self.transmission_sample_ratio = 0.5
        self.error_sample_ratio = 0.3
        self.save_step = 1
        self.stable_confidence_thres = 200
        self.unstable_time_window = 50
        self.min_radius = 0.01
        self.max_radius = 0.10
        self.scale_factor = 0.5
        self.color_sigma = 1.0
        self.depth_filter = False
        self.verbose = False

        self.keyframe_trans_thes = 0.3
        self.keyframe_theta_thes = 20
        self.global_keyframe_num = 3
        self.sync_tracker2mapper_method = "strict"
        self.sync_tracker2mapper_frames = 5

        self.map_capacity = 262144
        self.temp_capacity = 65536
        self.block_capacity = 4096
        self.tile_capacity = 1024
        self.use_pallas_blend = False
        self.use_fused_vjp = True
        self.optimize_freeze_binning = False
        self.optimize_compact = True
        self.multi_device = False
