"""Every name of the port that the harness hooks or reaches past its
public per-frame step for, in one place.

The benchmark drives ``rtgslam_torch`` through its per-frame step
(``session.py``), and reaches inside it at the names below: to render the
eval keyframe (``Mapper._render``), to keep what the timed path produced
for the check (``correctness.py``), to count and sample the blend launches
of the profiled slice (``trace.py``) and to plant faults (``faults.py``).  A change to the port that renames or removes one of
them, or stops calling it, must not leave a metric or a check quietly
empty, so:

- :func:`check` looks every name up at set-up and raises
  :class:`PortChanged` naming those it misses;
- :func:`patch` swaps one attribute while it is open and raises when the
  attribute is absent;
- the callers raise :class:`PortChanged` where a hooked name was never
  called or its calls do not pair with the profile's kernels.

``benchmark/README.md`` lists the same names.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, Tuple

# module -> the attributes the harness patches or calls (``Class.attr``
# for a class's)
HOOKED: Dict[str, Tuple[str, ...]] = {
    "rtgslam_torch.models.optimize": ("_adam_step",),
    "rtgslam_torch.ops.rasterize.blend": (
        "blend_bwd", "_launch", "blend_tiles", "blend_bwd_partials"),
    "rtgslam_torch.slam.mapper": ("Mapper.gaussians_add", "Mapper._render"),
    "rtgslam_torch.slam.tracker": ("Tracker.tracking", "convert_poses"),
}


class PortChanged(RuntimeError):
    """A name the harness hooks is gone from the port, or is no longer
    called where the harness expects it."""


def _resolve(module: str, dotted: str):
    obj = importlib.import_module(module)
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def check() -> None:
    """Raise :class:`PortChanged` unless every name of :data:`HOOKED` is
    in the port."""
    missing = []
    for module, names in HOOKED.items():
        for name in names:
            try:
                _resolve(module, name)
            except (AttributeError, ImportError):
                missing.append(f"{module}.{name}")
    if missing:
        raise PortChanged("the port no longer has " + ", ".join(missing)
                          + " (benchmark/port.py lists what the harness hooks)")


@contextlib.contextmanager
def patch(owner, name: str, make: Callable):
    """Replace ``owner.name`` by ``make(original)`` while open."""
    if not hasattr(owner, name):
        raise PortChanged(f"{getattr(owner, '__name__', owner)!s} has no "
                          f"attribute {name!r} to hook")
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield orig
    finally:
        setattr(owner, name, orig)
