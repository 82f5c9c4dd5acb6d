from .loader import (GroupParams, merge_dicts, read_config, read_config_dict,
                     save_config)
from .params import DatasetParams, MapParams, OptimizationParams, ParamGroup

__all__ = ["GroupParams", "merge_dicts", "read_config", "read_config_dict",
           "save_config", "ParamGroup", "DatasetParams", "OptimizationParams",
           "MapParams"]
