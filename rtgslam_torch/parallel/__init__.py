"""The multi-device path: a single-controller mesh of shard devices
(``rtgslam_tpu/parallel/``)."""

from .mesh import Mesh, make_mesh
from .sharded import (dp_global_optimize, dp_local_optimize, dp_optimize_step,
                      dryrun_multichip)
from .sp_optimize import sp_optimize_execute
from .sp_render import sp_render

__all__ = ["make_mesh", "dp_optimize_step", "dp_global_optimize",
           "dp_local_optimize", "dryrun_multichip", "sp_render"]
