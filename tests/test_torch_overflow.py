"""Port parity: ``Mapper.lifecycle_overflow`` is the JAX mapper's
``max_overflow`` at a count above 0, on the whole-frame, mesh and row-band
paths.

The JAX mapper folds one counter per frame, its lifecycle render's, when the
next frame's spawn or frame chain starts (``_cached_hwm``), so the last
frame's stays pending until a hand fold (``tests/test_slam_e2e.py:191``).
The port keeps that count beside its own ``max_overflow``, which takes every
render at the mapper's raster at once.  The reference
``tests/data/overflow_96x128_jax_cpu.json`` is the JAX mapper on the
conftest scene with ``test_overflow_tracked_across_run``'s undersized
capacities (tile 64, block 128), forward-only, ground-truth poses; with
``--bands 2`` the row-band step, where JAX folds once per band:

    JAX_PLATFORMS=cpu python tests/torch_parity.py --overflow --frames 4 --height 96 --width 128
    JAX_PLATFORMS=cpu python tests/torch_parity.py --overflow --bands 2 --frames 4 --height 96 --width 128

The mesh case (four virtual shards of the CPU) is held to the whole-frame
reference: forward-only, the mesh changes no render the count reads (the
JAX mapper's frame and lifecycle chains do not take its mesh).

Tolerances: none.  The counts of dropped entries, the pending counter after
each frame, the count before and after the fold and the per-frame gaussian
counts are integers and must be equal; the port's wider count is at least
JAX's.
"""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_parity  # noqa: E402

from rtgslam_torch.data.synthetic import make_cameras  # noqa: E402
from rtgslam_torch.parallel import make_mesh  # noqa: E402

torch.set_num_threads(1)


def _ref(bands=1):
    with open(torch_parity.overflow_reference(96, 128, bands)) as f:
        return json.load(f)


def test_overflow_reference_is_the_e2e_case(base_args):
    """The fixture's config is conftest's base_args with the undersized
    capacities of test_overflow_tracked_across_run, forward-only, and JAX
    counted dropped entries in it."""
    ref = _ref()
    keys = ref["overrides"]
    assert keys == json.loads(json.dumps(torch_parity.OVERFLOW_KEYS))
    for k, v in keys.items():
        if k not in ("tile_capacity", "block_capacity", "use_gt_pose",
                     "gaussian_update_iter", "final_global_iter"):
            assert getattr(base_args, k) == v, k
    assert (keys["tile_capacity"], keys["block_capacity"]) == (64, 128)
    assert keys["gaussian_update_iter"] == keys["final_global_iter"] == 0
    assert keys["use_gt_pose"] is True
    assert (ref["frames"], ref["height"], ref["width"]) == (4, 96, 128)
    assert len(ref["per_frame"]) == 4
    assert 0 < ref["max_overflow_before_fold"] < ref["max_overflow_after_fold"]


@pytest.mark.parametrize("path", ["whole", "mesh", "bands"])
def test_lifecycle_overflow_matches_jax(path):
    ref = _ref(2 if path == "bands" else 1)
    assert ref["overrides"].get("frame_bands", 1) == (2 if path == "bands" else 1)
    cams = make_cameras(n_frames=ref["frames"], H=ref["height"], W=ref["width"])
    mesh = make_mesh(devices=["cpu"] * 4) if path == "mesh" else None
    frames, before, after, wider = torch_parity.port_overflow_run(
        ref, cams, "cpu", mesh)
    assert [f["counts"] for f in frames] == [f["counts"] for f in ref["per_frame"]]
    assert [(f["folded"], f["pending"]) for f in frames] == \
        [(f["folded"], f["pending"]) for f in ref["per_frame"]]
    assert (before, after) == (ref["max_overflow_before_fold"],
                               ref["max_overflow_after_fold"])
    assert before > 0 and after > 0
    assert wider >= after
