"""Milliseconds of the pose backend per tracked frame: the port's span
``track.backend`` (the native backend's ``process_image_rgbd`` on the first
frame, ``track_with_icp_pose`` or ``track_with_orb_feature`` and the
trajectory read after), over the first session's frames before the
profiled slice.  Host work alone: the backend runs on the CPU."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _program import ms_per_frame  # noqa: E402


def read(run):
    return ms_per_frame(run, "track.frame", "track.backend")
