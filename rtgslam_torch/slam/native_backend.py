"""ctypes binding of the native C++ pose backend (``csrc/pose_backend.cc``).

Port of ``rtgslam_tpu/slam/native_backend.py``: the orbslam2-binding API
surface (reference call sites ``SLAM/multiprocess/tracker.py:225-260``)
over the C library, plus the pose-graph loop-closure hook
(``add_loop_constraint``) whose corrected trajectory the mapper re-applies
through ``update_poses``.  The library is the port's own copy of the
source, built with ``g++`` at first use (``utils/cuda_build.py::build_host``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..utils.cuda_build import build_host


class NativePoseBackend:
    def __init__(self, lib_path: Optional[str] = None, vocab_path: str = "",
                 settings_path: str = ""):
        """``lib_path`` defaults to the port's library, built if missing."""
        self._lib = ctypes.CDLL(os.path.abspath(lib_path or build_host("pose_backend")))
        self._lib.pb_create.restype = ctypes.c_void_p
        for name, argtypes in {
            "pb_destroy": [ctypes.c_void_p],
            "pb_initialize": [ctypes.c_void_p, ctypes.c_int],
            "pb_shutdown": [ctypes.c_void_p],
            "pb_set_camera": [ctypes.c_void_p, ctypes.c_double,
                              ctypes.c_double, ctypes.c_double,
                              ctypes.c_double, ctypes.c_int, ctypes.c_int,
                              ctypes.c_double],
            "pb_process_image_rgbd": [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_double],
            "pb_track_with_icp_pose": [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_double],
            "pb_track_with_orb_feature": [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p, ctypes.c_double],
            "pb_set_window_ba": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int],
            "pb_add_loop_constraint": [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_double),
                                       ctypes.c_double, ctypes.c_int],
            "pb_get_trajectory": [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_double)],
            "pb_get_keyframes": [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_double)],
        }.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        for name in ("pb_trajectory_size", "pb_last_track_ok",
                     "pb_last_track_inliers", "pb_last_frame_reused",
                     "pb_keyframe_size"):
            fn = getattr(self._lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        self._h = self._lib.pb_create()
        self._camera = None

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.pb_destroy(h)

    # -- orbslam2 API -------------------------------------------------------
    def set_use_viewer(self, flag: bool) -> None:
        pass

    def initialize(self, useicp: bool) -> None:
        self._lib.pb_initialize(self._h, int(useicp))

    def shutdown(self) -> None:
        self._lib.pb_shutdown(self._h)

    def set_window_ba(self, enable: bool, window: int = -1,
                      every: int = -1, iters: int = -1) -> None:
        """Windowed refinement of recent poses over cross-frame feature
        tracks (the local-BA role of the reference backend, reference
        tracker.py:225-241; ``window_refine`` in the source).  -1 keeps a
        knob's current value."""
        self._lib.pb_set_window_ba(self._h, int(enable), int(window),
                                   int(every), int(iters))

    def set_camera(self, K: np.ndarray, width: int, height: int,
                   depth_scale: float = 1000.0) -> None:
        """Intrinsics + raw-depth scale; required for real feature tracking
        (without it track_with_orb_feature degrades to pose-hold)."""
        K = np.asarray(K, np.float64)
        self._camera = (int(width), int(height))
        self._lib.pb_set_camera(self._h, float(K[0, 0]), float(K[1, 1]),
                                float(K[0, 2]), float(K[1, 2]),
                                int(width), int(height), float(depth_scale))

    def _img_ptrs(self, color, depth):
        """(color_u8 [H,W,3], depth_u16 [H,W]) -> the contiguous arrays and
        their C pointers; None -> null.  The caller keeps the arrays alive
        across the call.  With a camera set, the frames must have its size:
        the library reads width x height pixels."""
        if color is None or depth is None:
            return None, None, ctypes.c_void_p(), ctypes.c_void_p()
        c = np.ascontiguousarray(color, dtype=np.uint8)
        d = np.ascontiguousarray(depth, dtype=np.uint16)
        if self._camera is not None:
            W, H = self._camera
            if c.shape != (H, W, 3) or d.shape != (H, W):
                raise ValueError(f"frames of {c.shape} / {d.shape} for a "
                                 f"{H}x{W} camera")
        return (c, d, ctypes.c_void_p(c.ctypes.data),
                ctypes.c_void_p(d.ctypes.data))

    def process_image_rgbd(self, color, depth, timestamp: float) -> None:
        c, d, cp, dp = self._img_ptrs(color, depth)
        self._lib.pb_process_image_rgbd(self._h, cp, dp, float(timestamp))

    def track_with_icp_pose(self, color, depth, pose_rel: np.ndarray,
                            timestamp: float) -> None:
        arr = np.ascontiguousarray(pose_rel, dtype=np.float32)
        if arr.shape != (4, 4):
            raise ValueError(f"pose_rel must be 4x4, got {arr.shape}")
        c, d, cp, dp = self._img_ptrs(color, depth)
        self._lib.pb_track_with_icp_pose(
            self._h, cp, dp,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            float(timestamp))

    def track_with_orb_feature(self, color, depth, timestamp: float) -> None:
        c, d, cp, dp = self._img_ptrs(color, depth)
        self._lib.pb_track_with_orb_feature(self._h, cp, dp, float(timestamp))

    def last_track_ok(self) -> bool:
        return bool(self._lib.pb_last_track_ok(self._h))

    def last_track_inliers(self) -> int:
        return int(self._lib.pb_last_track_inliers(self._h))

    def last_frame_reused(self) -> bool:
        """Whether the last image call ran its feature pass and window
        update in the frame buffers kept since ``set_camera``, allocating
        none."""
        return bool(self._lib.pb_last_frame_reused(self._h))

    def add_loop_constraint(self, i: int, j: int, T_ij: np.ndarray,
                            weight: float = 1.0, iterations: int = 50) -> None:
        arr = np.ascontiguousarray(T_ij, dtype=np.float64)
        if arr.shape != (4, 4):
            raise ValueError(f"T_ij must be 4x4, got {arr.shape}")
        self._lib.pb_add_loop_constraint(
            self._h, int(i), int(j),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            float(weight), int(iterations))

    def _rows(self, size_fn, get_fn):
        n = size_fn(self._h)
        out = np.zeros((n, 13), np.float64)
        if n:
            get_fn(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        return [tuple(row) for row in out]

    def get_trajectory_points(self):
        return self._rows(self._lib.pb_trajectory_size, self._lib.pb_get_trajectory)

    def get_keyframe_points(self):
        return self._rows(self._lib.pb_keyframe_size, self._lib.pb_get_keyframes)
