"""YAML config with recursive ``parent:`` inheritance.

Copy of ``rtgslam_tpu/config/loader.py::read_config`` (reference
``utils/config_utils.py:20-33``), so the port runs without the JAX
package: a config may name a ``parent`` YAML, the child's keys win, and
the chain resolves until ``parent: None`` or a missing file.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import yaml


class GroupParams:
    """Plain attribute namespace for resolved config values."""


def merge_dicts(parent: Dict[str, Any], child: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``child`` over ``parent`` (child wins)."""
    out = dict(parent)
    for key, value in child.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = merge_dicts(out[key], value)
        else:
            out[key] = value
    return out


def read_config(config_path: str) -> GroupParams:
    """Resolve a YAML config (with parents) into an attribute namespace."""
    with open(config_path, "r") as f:
        config = yaml.safe_load(f) or {}
    while (config.get("parent") not in (None, "None")
           and os.path.exists(config["parent"])):
        with open(config["parent"], "r") as f:
            parent = yaml.safe_load(f) or {}
        grandparent = parent.get("parent", "None")
        config = merge_dicts(parent, config)
        config["parent"] = grandparent
    group = GroupParams()
    for key, value in config.items():
        setattr(group, key.lstrip("_"), value)
    return group
