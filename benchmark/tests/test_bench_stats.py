"""The arithmetic of the benchmark's metrics, on hand-made numbers."""

import math
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import stats  # noqa: E402


def test_fps_counts_a_cut_session_and_the_end_of_session_pass():
    # two sessions: 48 frames and a pass, then 10 frames of a cut one; the
    # window's seconds run to the end of the last completed frame
    frames = 48 + 10
    assert stats.fps(frames, 29.0) == pytest.approx(2.0)
    with pytest.raises(ValueError):
        stats.fps(3, 0.0)


def test_the_session_rate_before_the_slice_counts_the_host_between_frames():
    import manifest

    read = manifest.readers({"per_layer": [{"name": "session.fps_before_slice"}]},
                            os.path.dirname(stats.__file__) + "/..", "any")[
        "session.fps_before_slice"]
    # frames 0-2 of session 0 before a slice at frame 3: 0.1 s of work each,
    # 0.15 s apart, so the first starts at 0.9 and the third ends at 1.3
    frames = [{"session": 0, "index": i, "track_ms": 60.0, "map_ms": 40.0,
               "end": 1.0 + 0.15 * i} for i in range(5)]
    assert read({"frames": frames, "slice": [3, 4]}) == pytest.approx(3 / 0.4)
    assert read({"frames": frames[3:], "slice": [3, 4]}) is None


@pytest.mark.parametrize("n,expect", [(10, 9), (100, 90), (101, 91), (91, 82), (1, 1)])
def test_p90_is_the_nearest_rank(n, expect):
    values = list(range(1, n + 1))
    np.random.default_rng(0).shuffle(values)
    assert stats.percentile(values, 90) == expect


def test_median_and_empty_inputs():
    assert stats.median([3, 1, 2]) == 2
    assert stats.median([4, 1, 3, 2]) == 2.5
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_union_of_intervals_and_the_gaps_between():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (5.0, 5.0)]
    assert stats.merge(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, -1.0, 6.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 6.0)]
    # clipped to the window: the idle share of [1, 3.5) is 1 - 1.5 / 2.5
    busy = stats.union_length((max(s, 1.0), min(e, 3.5)) for s, e in iv)
    assert 1.0 - busy / 2.5 == pytest.approx(0.4)


def test_ate_is_invariant_to_a_rigid_motion_and_reads_a_shift():
    rng = np.random.default_rng(1)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = rng.normal(size=(20, 3))
    a = math.radians(30)
    R = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0],
                  [0, 0, 1]])
    est = gt.copy()
    est[:, :3, 3] = gt[:, :3, 3] @ R.T + np.array([1.0, 2.0, 3.0])
    assert stats.ate_rmse_cm(est, gt) == pytest.approx(0.0, abs=1e-9)
    assert stats.rotation_errors_deg(est, gt).max() == pytest.approx(0.0, abs=1e-6)
    est[5, :3, 3] += np.array([0.01, 0.0, 0.0])
    err = stats.position_errors_m(est, gt)
    assert err.argmax() == 5 and 0.008 < err.max() < 0.0101
    b = math.radians(2.0)
    est[7, :3, :3] = np.array([[1, 0, 0], [0, math.cos(b), -math.sin(b)],
                               [0, math.sin(b), math.cos(b)]])
    rot = stats.rotation_errors_deg(est, gt)
    assert rot.argmax() == 7 and rot.max() == pytest.approx(2.0, abs=0.05)


def test_psnr():
    a = np.full((4, 4, 3), 0.5)
    assert stats.psnr(a + 0.1, a) == pytest.approx(20.0)
    assert stats.psnr(a, a) == math.inf
