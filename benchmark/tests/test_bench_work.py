"""The benchmark's frozen copy of the kernels' work counts and bounds
(``work.py``) against ``chip_smoke.py``'s, on CPU tensors."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
import work  # noqa: E402
import chip_smoke  # noqa: E402
from rtgslam_torch.ops.rasterize import blend  # noqa: E402


@pytest.mark.parametrize("Kt", [128, 512])
def test_work_counts_and_bounds_match_chip_smoke(Kt):
    feat, order, lists, counts, origins = chip_smoke.random_tiles("cpu", T=48, Kt=Kt, V=3000)
    _, _, done, _ = blend.blend_tiles(feat, order, lists, counts, origins, 0.6,
                                      1e-4, residuals=True)
    got = work.live_work(feat, lists, counts, done, origins)
    want = chip_smoke.live_work(feat, lists, counts, done, origins)
    assert got == want
    assert got["nonzero"] > 0
    T = lists.shape[0]
    n_chunks = Kt // min(work.CHUNK, Kt)
    for kind in ("inference", "residual", "transmission", "bwd"):
        assert work.work_bound(kind, got, T, n_chunks) == \
            chip_smoke.work_bound(kind, want, T, n_chunks)


def test_the_peaks_are_the_data_sheets():
    assert (work.PEAK_FP32, work.PEAK_BYTES) == (chip_smoke.PEAK_FP32, chip_smoke.PEAK_BYTES)
    assert work.bound(67e9, 0) == (pytest.approx(1.0), "operations")
    assert work.bound(0, 3.35e9) == (pytest.approx(1.0), "bytes")
