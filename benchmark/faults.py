"""Faults planted under the timed path, to show that ``correct`` reads
them: each is a context manager that patches the port's module attributes
(``port.patch``) while it is open.  ``control.py`` reads them at a cell's own size
on the card; ``tests/test_bench_cells.py`` at a small size on the CPU.

- ``adam_unchanged``: the optimizer's step returns its state unchanged;
- ``adam_moments_dropped``: every optimizer step acts as the first, its
  moments and bias correction lost;
- ``pose_unchanged``: the tracker's step returns its state unchanged (each
  frame keeps the previous frame's pose);
- ``half_the_tiles``: the blend leaves every other tile out;
- ``pose_altered``: one tracked pose altered by 2 cm where it is produced;
- ``colour_altered``: one tile of every blend's colour altered.

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import numpy as np

import port


def adam_unchanged():
    from rtgslam_torch.models import optimize

    return port.patch(optimize, "_adam_step",
                      lambda orig: lambda params, grads, m, v, step, lrs, mask:
                      (params, m, v))


def adam_moments_dropped():
    """Every step forgets the moments it was handed and acts as the first
    (m = v = 0, t = 1): lr times the gradient's sign."""
    import torch
    from rtgslam_torch.models import optimize

    def make(orig):
        def first_step(params, grads, m, v, step, lrs, mask):
            zero = {k: torch.zeros_like(x) for k, x in m.items()}
            return orig(params, grads, zero, dict(zero), 0, lrs, mask)
        return first_step

    return port.patch(optimize, "_adam_step", make)


def _after_tracking(change):
    from rtgslam_torch.slam.tracker import Tracker

    def make(orig):
        def tracking(self, frame, frame_map):
            ok = orig(self, frame, frame_map)
            change(self)
            return ok
        return tracking

    return port.patch(Tracker, "tracking", make)


@contextlib.contextmanager
def pose_unchanged():
    """The pose never moves from the first frame's: on the fused path each
    solve's pose is replaced by the previous one; on the staged path the
    pose backend's trajectory, which the tracker adopts, holds the first
    pose throughout."""
    from rtgslam_torch.slam import tracker as tracker_module

    def keep(tracker):
        if len(tracker.pose_es) > 1:
            tracker.pose_es[-1] = tracker.pose_es[-2].copy()

    def frozen(orig):
        def convert(rows):
            poses, rest = orig(rows)
            # the first frame's pose, which the tracker sets to the identity
            return [np.eye(4) for _ in poses], rest
        return convert

    with _after_tracking(keep), port.patch(tracker_module, "convert_poses", frozen):
        yield


def pose_altered():
    def alter(tracker):
        if len(tracker.pose_es) == 4:
            tracker.pose_es[-1] = tracker.pose_es[-1].copy()
            tracker.pose_es[-1][:3, 3] += 0.02
    return _after_tracking(alter)


def half_the_tiles():
    from rtgslam_torch.ops.rasterize import blend

    def make(orig):
        def half(feat, order, lists, counts, origins, *a, **kw):
            counts = counts.clone()
            counts[1::2] = 0
            return orig(feat, order, lists, counts, origins, *a, **kw)
        return half

    return port.patch(blend, "blend_tiles", make)


def colour_altered():
    from rtgslam_torch.ops.rasterize import blend

    def make(orig):
        def altered(*a, **kw):
            out = orig(*a, **kw)
            tiles = out if hasattr(out, "color") else out[0]
            tiles.color[0] += 0.05
            return out
        return altered

    return port.patch(blend, "blend_tiles", make)


FAULTS = {f.__name__: f for f in (adam_unchanged, adam_moments_dropped,
                                  pose_unchanged, half_the_tiles, pose_altered,
                                  colour_altered)}
