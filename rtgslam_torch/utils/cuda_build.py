"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``rtgslam_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` at first use (never at import) into
``build/rtgslam_torch/`` at the repository root.  The library file name
carries a hash of the source and the flags, so an edited kernel rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rtgslam_torch")
# no --use_fast_math (expf must hold 1e-5 against the plain twin) and no FMA
# contraction, so the kernel rounds like the elementwise plain version
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}
# name -> {"seconds": build wall time (0.0 when the cached file was used),
#          "ptxas": nvcc's resource report, "path": library file}
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, then
    load it (once per process)."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = os.path.join(CSRC, name + ".cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
        info = {"seconds": 0.0, "ptxas": "", "path": path}
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, path)   # atomic: concurrent processes race safely
            info.update(seconds=time.perf_counter() - t0, ptxas=proc.stderr)
        _libs[name] = ctypes.CDLL(path)
        build_info[name] = info
        return _libs[name]
