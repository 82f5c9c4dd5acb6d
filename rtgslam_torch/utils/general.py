"""Run-time helpers: seeding, timestamped stdout, the run directory, the
device.

``inverse_sigmoid_np``, ``safe_state`` and ``create_workspace`` are copies
of ``rtgslam_tpu/utils/general.py`` (:21, :45, :50), which the JAX package
reaches only through a module that imports JAX.
"""

from __future__ import annotations

import os
import random
import shutil
import sys
from datetime import datetime

import numpy as np
import torch

DEFAULT_SEED = 2024  # determinism aid, matching the reference's fixed seed


def set_seed(seed: int = DEFAULT_SEED) -> None:
    random.seed(seed)
    np.random.seed(seed)


def inverse_sigmoid_np(x: np.ndarray) -> np.ndarray:
    return np.log(x / (1 - x))


class _TimestampedStream:
    """Wrap a stream so each line is suffixed with a wall-clock stamp
    (reference ``utils/general_utils.py:153-177`` ``safe_state``)."""

    def __init__(self, stream, silent: bool):
        self.stream = stream
        self.silent = silent

    def write(self, text):
        if self.silent:
            return
        if text.endswith("\n"):
            stamp = datetime.now().strftime("%d/%m %H:%M:%S")
            text = text.replace("\n", f" [{stamp}]\n")
        self.stream.write(text)

    def flush(self):
        self.stream.flush()


def safe_state(quiet: bool = False, seed: int = DEFAULT_SEED) -> None:
    """Stamp every stdout line with the time (or drop it when ``quiet``)
    and seed Python's and numpy's global generators.  The entry points
    restore ``sys.stdout`` when they return."""
    sys.stdout = _TimestampedStream(sys.stdout, quiet)
    set_seed(seed)


def create_workspace(save_path: str, wipe: bool = True) -> None:
    """Create the run directory layout (reference ``mapper.py:914-926``)."""
    if wipe and os.path.exists(save_path):
        shutil.rmtree(save_path)
    for sub in ("", "eval_render", "save_model", "save_traj", "eval_metric"):
        os.makedirs(os.path.join(save_path, sub), exist_ok=True)


def require_device(name: str):
    """The torch device an entry point runs on.  A CUDA device that is not
    there is an error: nothing falls back to the CPU, which runs only when
    asked for by name."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return device


def sync(device) -> None:
    """Wait for the device's queued work, so a host clock read after it
    charges that work to the stage that queued it."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
