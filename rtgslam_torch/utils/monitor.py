"""Run-time performance recorder (port of ``rtgslam_tpu/utils/monitor.py``,
reference ``utils/monitor.py``).

Tracks running means and maxima of named timers, derives the reference's
FPS rule ``fps = 1 / mean(mapping time)`` and writes ``performance.json``.
Beside the JAX file's keys, ``samples`` keeps every value of each timer, so
a reader can take medians.  ``watch_memory`` reads the CUDA allocator.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch


class Recorder:
    def __init__(self, device_index: int = 0, record_mem: bool = False):
        self.device_index = device_index
        self.record_mem = record_mem
        self.mean_dict: Dict[str, float] = defaultdict(float)
        self.count_dict: Dict[str, int] = defaultdict(int)
        self.max_dict: Dict[str, float] = defaultdict(float)
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.extra: Dict[str, float] = {}

    def update_mean(self, name: str, value: float, count: int = 1) -> None:
        total = self.mean_dict[name] * self.count_dict[name] + value * count
        self.count_dict[name] += count
        self.mean_dict[name] = total / max(self.count_dict[name], 1)
        self.samples[name].append(value)

    def update_max(self, name: str, value: float) -> None:
        self.max_dict[name] = max(self.max_dict[name], value)

    @contextmanager
    def time_block(self, name: str):
        """Add the host-clock seconds the block took to ``name``'s mean
        (``time_block`` :37).  It does not synchronize the device, as the
        JAX one does not: work the block queued on the GPU and did not wait
        for is not in the time."""
        start = time.time()
        yield
        self.update_mean(name, time.time() - start, 1)

    def watch_memory(self) -> Optional[float]:
        """Record the CUDA memory in use and the allocator's peak, in GiB;
        None when no GPU is in use."""
        if not torch.cuda.is_available():
            return None
        used = torch.cuda.memory_allocated(self.device_index) / 1024 ** 3
        peak = torch.cuda.max_memory_allocated(self.device_index) / 1024 ** 3
        self.update_max("device_mem_gib", used)
        self.update_max("device_peak_mem_gib", peak)
        return used

    def cal_fps(self) -> float:
        mapping = self.mean_dict.get("mapping", 0.0)
        fps = 1.0 / mapping if mapping > 0 else 0.0
        self.extra["fps"] = fps
        return fps

    def save(self, save_path: str, name: str = "performance.json") -> None:
        os.makedirs(save_path, exist_ok=True)
        payload = {
            "mean": dict(self.mean_dict),
            "count": dict(self.count_dict),
            "max": dict(self.max_dict),
            "samples": dict(self.samples),
            **self.extra,
        }
        with open(os.path.join(save_path, name), "w") as f:
            json.dump(payload, f, indent=2)
