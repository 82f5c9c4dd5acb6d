from .loader import GroupParams, read_config
from .params import OptimizationParams

__all__ = ["GroupParams", "OptimizationParams", "read_config"]
