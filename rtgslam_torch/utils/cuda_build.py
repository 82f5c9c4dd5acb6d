"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``rtgslam_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` at first use (never at import) into
``build/rtgslam_torch/`` at the repository root.  The library file name
carries a hash of the source, of every ``csrc/*.cuh`` header and of the
flags, so an edited kernel or header rebuilds.  ``build_host`` does the
same with ``g++`` for the one host-only source, ``csrc/pose_backend.cc``.
"""

from __future__ import annotations

import ctypes
import glob
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
# contraction by the compiler: every fused multiply-add is an explicit
# __fmaf_rn in the source, and the one approximate intrinsic, K2's
# __fdividef, is written out there too (csrc/blend_common.cuh says which)
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


def build(*names: str) -> None:
    """Compile every ``csrc/<name>.cu`` whose hashed library is missing, one
    ``nvcc`` per source, all started together; then load each library (once
    per process)."""
    with _lock:
        t0 = time.perf_counter()
        jobs = []
        for name in names:
            if name in _libs:
                continue
            src = os.path.join(CSRC, name + ".cu")
            h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
            for part in [src, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
                with open(part, "rb") as f:
                    h.update(f.read())
            digest = h.hexdigest()[:16]
            path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
            build_info[name] = {"seconds": 0.0, "ptxas": "", "path": path}
            if not os.path.exists(path):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                jobs.append((name, src, path, tmp, subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for name, src, path, tmp, proc in jobs:   # wait for every nvcc
            _, stderr = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src}:\n{stderr}")
                continue
            os.replace(tmp, path)   # atomic: concurrent processes race safely
            build_info[name].update(seconds=time.perf_counter() - t0,
                                    ptxas=stderr)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(build_info[name]["path"])


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    build(name)
    return _libs[name]


# native/Makefile's flags for the pose backend
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")


def build_host(name: str) -> str:
    """Compile ``csrc/<name>.cc`` (plain C++ with a C interface, no CUDA)
    with ``g++`` into ``build/rtgslam_torch/lib<name>_<hash>.so`` unless that
    file exists, the hash taken over the source and the flags; returns the
    library's path.  A failed or impossible build raises."""
    with _lock:
        src = os.path.join(CSRC, name + ".cc")
        h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
        with open(src, "rb") as f:
            h.update(f.read())
        path = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
        build_info[name] = {"seconds": 0.0, "ptxas": "", "path": path}
        if not os.path.exists(path):
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: {src} cannot be built")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {src}:\n{proc.stderr}")
            os.replace(tmp, path)
            build_info[name]["seconds"] = time.perf_counter() - t0
        return path
