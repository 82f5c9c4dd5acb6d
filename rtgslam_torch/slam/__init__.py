"""Tracker, mapper, evaluation and the per-frame SLAM loop."""
