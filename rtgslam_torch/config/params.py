"""Optimization weights and learning rates.

Copy of ``rtgslam_tpu/config/params.py::OptimizationParams`` (:74, reference
``arguments/__init__.py:104-120``), so the port runs without the JAX
package.  ``extract`` projects a resolved config namespace onto the keys
this group owns, as ``ParamGroup.extract`` does: the config's values, not
the defaults below, reach the optimizer.
"""

from __future__ import annotations

from .loader import GroupParams


class OptimizationParams:
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

    def extract(self, args) -> GroupParams:
        group = GroupParams()
        own = vars(self)
        for key, value in vars(args).items():
            if key in own:
                setattr(group, key, value)
        return group
