from .loader import GroupParams, read_config

__all__ = ["GroupParams", "read_config"]
