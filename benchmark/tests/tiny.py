"""A copy of the benchmark at a size a CPU test run holds.

``make_root(tmp)`` copies ``BENCHMARK.json`` and ``benchmark/`` into
``tmp``, links the port's package beside them and adds one configuration,
``tiny_96x128`` (the Replica configuration at 96x128 with few iterations),
its limits and the cell ``tiny_96x128.orbit``, as a later change would add a
cell: new files and a new entry, no edit of a file the benchmark has.
"""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = "tiny_96x128"
CELL = TINY + ".orbit"
TINY_ARGS = {"frame_num": 8, "gaussian_update_frame": 2,
             "gaussian_update_iter": 3, "final_global_iter": 2,
             "uniform_sample_num": 600, "map_capacity": 16384,
             "temp_capacity": 4096, "max_visible": 8192, "tile_capacity": 256}
TINY_LIMITS = {"bin_overflow": {"max": 0}, "pose_err_max_cm": {"max": 1.5},
               "pose_rot_err_max_deg": {"max": 5.0},
               "render_p99": {"max": 1e-3}, "k2_grad_rel": {"max": 1e-3},
               "adam_rel": {"max": 1e-3}, "adam_m_rel": {"max": 1e-3},
               "adam_v_rel": {"max": 1e-3}, "spawn_gap_mm": {"max": 1.0}}


def make_root(tmp: str, base: str = "replica_680x1200", mix: str = "orbit") -> str:
    root = os.path.join(tmp, "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "rtgslam_torch"), os.path.join(root, "rtgslam_torch"))
    with open(os.path.join(REPO, "benchmark", "configs", base + ".json")) as f:
        cfg = json.load(f)
    cfg["frame_size"] = [96, 128]
    cfg["args"].update(TINY_ARGS)
    with open(os.path.join(root, "benchmark", "configs", TINY + ".json"), "w") as f:
        json.dump(cfg, f)
    # the numbers the full-size cell of this configuration compares
    limits_dir = os.path.join(root, "benchmark", "reference", "limits")
    full = [n for n in os.listdir(limits_dir) if n.startswith(base + ".")][0]
    with open(os.path.join(limits_dir, full)) as f:
        compared = json.load(f)["limits"]
    with open(os.path.join(limits_dir, CELL + ".json"), "w") as f:
        json.dump({"limits": {k: v for k, v in TINY_LIMITS.items() if k in compared}}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": TINY, "source": "tests", "file":
                             f"benchmark/configs/{TINY}.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": TINY, "traffic": mix,
                               "chips": 1, "why": "CPU tests"})
    # the cell reports every metric, those held to some cells too
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def orbit_at(W: int, H: int) -> dict:
    """The orbit's sensor scaled to a W x H frame (Replica's 90 degree
    field of view)."""
    return {"fx": W / 2, "fy": W / 2, "cx": W / 2 - 0.5, "cy": H / 2 - 0.5}
