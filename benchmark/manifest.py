"""Find a cell's configuration, traffic mix and per-layer readers by name.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, which this module finds by the
name ``BENCHMARK.json`` gives it, so a later change adds a cell, a mix, a
configuration or a metric by adding files:

- a configuration: the file named by its ``configs`` entry;
- a traffic mix: ``benchmark/traffic/<mix>.json``;
- a per-layer metric: ``benchmark/metrics/<metric>.py``, whose
  ``read(run)`` returns the number or None.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))


def load(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json "
                     f"(have {[w['name'] for w in manifest['workloads']]})")


def config(manifest: Dict, root: str, name: str) -> Dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise SystemExit(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(root: str, name: str) -> Dict:
    with open(os.path.join(root, "benchmark", "traffic", name + ".json")) as f:
        return json.load(f)


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def end_to_end(manifest: Dict, workload: str) -> List[Dict]:
    return [m for m in manifest["end_to_end"] if applies(m, workload)]


def readers(manifest: Dict, root: str, workload: str) -> Dict[str, Callable]:
    """The ``read`` function of every per-layer metric of ``workload``."""
    out = {}
    for m in manifest["per_layer"]:
        if not applies(m, workload):
            continue
        path = os.path.join(root, "benchmark", "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + m["name"].replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        out[m["name"]] = module.read
    return out
