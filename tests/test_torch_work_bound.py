"""The work ``chip_smoke.py`` charges each blend launch with when it states
the launch's bound: ``live_work``'s counts against a brute-force loop over
the tiles, and ``work_bound``'s bytes against the sizes of the arguments
and outputs on tiles where every list is full, walked to its end and every
row is named (then the two must agree exactly).  CPU only, plain twins."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from rtgslam_torch.ops.rasterize import blend  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("Kt,seed", [(128, 0), (384, 1), (85, 2)])
def test_live_work_matches_brute_force(Kt, seed):
    feat, order, lists, counts, origins = chip_smoke.random_tiles(
        torch.device("cpu"), T=24, Kt=Kt, V=600, seed=seed)
    V, chunk = feat.shape[0] - 1, min(blend.CHUNK, Kt)
    # any done, so that min(count, chunk x done) trims inside the lists
    done = torch.from_numpy(np.random.default_rng(seed).integers(
        0, Kt // chunk + 1, size=24).astype(np.int32))
    w = chip_smoke.live_work(feat, lists, counts, done, origins)
    pix = blend.tile_pixels(origins)
    pairs = nonzero = positions = tiles = 0
    rows = set()
    for t in range(24):
        n = min(int(counts[t]), chunk * int(done[t]))
        entries = lists[t, :n].long()
        alpha = blend._chunk_alphas(feat[entries][None], pix[t][None])[0]
        pairs += 256 * n
        nonzero += int((alpha != 0).sum())
        positions += n
        tiles += n > 0
        rows |= {int(e) for e in entries if e < V}
    assert w == {"pairs": pairs, "nonzero": nonzero, "positions": positions,
                 "rows": len(rows), "chunks": int(done.sum()), "tiles": tiles}
    assert 0 < nonzero < pairs


def _full_tiles(T=8, Kt=256, V=1024):
    """Every list full (count Kt) and walked to its end, every row named."""
    feat, order, _, _, origins = chip_smoke.random_tiles(
        torch.device("cpu"), T=T, Kt=Kt, V=V, seed=5)
    lists = torch.arange(V, dtype=torch.int32).reshape(-1, Kt).repeat(
        T * Kt // V, 1)
    counts = torch.full((T,), Kt, dtype=torch.int32)
    done = torch.full((T,), Kt // min(blend.CHUNK, Kt), dtype=torch.int32)
    return feat, order, lists, counts, origins, done


@pytest.mark.parametrize("kind", ["inference", "residual", "transmission",
                                  "bwd"])
def test_work_bound_bytes_equal_sizes_when_all_live(kind):
    feat, order, lists, counts, origins, done = _full_tiles()
    T, Kt = lists.shape
    n_chunks = Kt // min(blend.CHUNK, Kt)
    w = chip_smoke.live_work(feat, lists, counts, done, origins)
    assert w["rows"] == feat.shape[0] - 1 and w["chunks"] == T * n_chunks
    w.update(pairs=0, nonzero=0)        # no operations: the bound is bytes
    ms, by = chip_smoke.work_bound(kind, w, T, n_chunks)
    assert by == "bytes"
    rows = feat[:-1]                    # the sentinel row is never read
    nb = chip_smoke.nbytes
    if kind == "transmission":
        want = nb(rows[:, :6], lists, counts, origins) + 4 * 256 * T
    else:
        out, entry, done_, cc = blend.blend_tiles(
            feat, order, lists, counts, origins, 0.6, 1e-4, residuals=True)
        want = nb(rows, order, lists, counts, origins)
        if kind == "bwd":
            want += nb(done_, entry, cc, out.color, out.depth, out.T_final,
                       out.depth_index) + 4 * blend.NGRAD * T * Kt
        else:
            want += nb(*out) + (nb(entry, done_, cc) if kind == "residual"
                                else 0)
    assert ms * chip_smoke.PEAK_BYTES / 1e3 == pytest.approx(want, rel=1e-12)
