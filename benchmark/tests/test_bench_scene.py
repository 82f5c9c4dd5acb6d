"""The on-card room generator against the port's numpy room
(``rtgslam_torch/data/synthetic.py``), on the CPU at a small size."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import scene  # noqa: E402
from rtgslam_torch.data import synthetic  # noqa: E402


def test_cast_matches_the_numpy_room():
    rng = np.random.default_rng(3)
    room = synthetic.RoomScene()
    origins = rng.uniform([1.4, 1.2, 1.4], [2.6, 1.9, 2.6], size=(4096, 3))
    dirs = rng.normal(size=(4096, 3))
    c_np, t_np, n_np = room.cast(origins, dirs)
    c, t, n = scene.cast(torch.as_tensor(origins), torch.as_tensor(dirs))
    np.testing.assert_allclose(t.numpy(), t_np, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(c.numpy(), c_np, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(n.numpy(), n_np, rtol=1e-12, atol=1e-12)


def test_orbit_matches_at_phase_zero_and_moves_with_the_phase():
    room = synthetic.RoomScene()
    ref = synthetic.orbit_trajectory(room, 12, 616, 1.33)
    got = scene.orbit_trajectory(12, 616, 1.33)
    np.testing.assert_allclose(np.stack(got), np.stack(ref), atol=1e-12)
    shifted = scene.orbit_trajectory(12, 616, 1.33, phase=5 / 616)
    np.testing.assert_allclose(shifted[0], ref[5], atol=1e-12)


def test_frames_match_render_rgbd_quantised():
    H, W = 24, 32
    sensor = {"fx": 20.0, "fy": 20.0, "cx": 15.5, "cy": 11.5,
              "depth_scale": 5000.0}
    seq = scene.make_sequence(sensor, {"frames_per_rev": 900, "look_mult": 1.33,
                                       "start_phase": 0.37}, H, W, 3, device="cpu")
    room = synthetic.RoomScene()
    raw = scene.orbit_trajectory(3, 900, 1.33, seq["phase"])
    K = scene.intrinsics(sensor)
    for i, c2w in enumerate(raw):
        colour, depth = synthetic.render_rgbd(room, c2w, K, H, W)
        assert np.abs(seq["colour"][i] - colour).max() <= 0.5 / 255 + 1e-6
        assert np.abs(seq["depth"][i][..., 0] - depth).max() <= 0.5 / 5000 + 1e-6
        np.testing.assert_allclose(seq["poses"][i], np.linalg.inv(raw[0]) @ c2w,
                                   atol=1e-12)
    np.testing.assert_allclose(seq["poses"][0], np.eye(4), atol=1e-12)


def test_the_traffic_file_fixes_the_inputs():
    sensor = {"fx": 8.0, "fy": 8.0, "cx": 7.5, "cy": 5.5, "depth_scale": 5000.0,
              "depth_noise_k": 1.425e-3, "noise_seed": 1}
    motion = {"frames_per_rev": 616, "look_mult": 1.33, "start_phase": 0.0}
    a = scene.make_sequence(sensor, motion, 12, 16, 2, device="cpu")
    b = scene.make_sequence(sensor, motion, 12, 16, 2, device="cpu")
    c = scene.make_sequence(dict(sensor, noise_seed=2), motion, 12, 16, 2, device="cpu")
    for x, y in zip(a["depth"], b["depth"]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a["depth"][0], c["depth"][0])
    exact = scene.make_sequence(dict(sensor, depth_noise_k=0.0), motion, 12, 16, 2,
                                device="cpu")
    noise = a["depth"][0] - exact["depth"][0]
    z = exact["depth"][0]
    # sigma_z = k z^2, to within the quantisation step
    assert 0.5 < np.std(noise / (1.425e-3 * z * z)) < 1.5


@pytest.mark.cuda
def test_frames_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sensor = {"fx": 600.0, "fy": 600.0, "cx": 599.5, "cy": 339.5,
              "depth_scale": 6553.5}
    motion = {"frames_per_rev": 900, "look_mult": 1.33}
    cpu = scene.make_sequence(sensor, motion, 680, 1200, 2, device="cpu")
    gpu = scene.make_sequence(sensor, motion, 680, 1200, 2, device="cuda")
    for a, b in zip(cpu["depth"], gpu["depth"]):
        # a hit decided on the other side of a float64 tie is a handful of pixels
        assert np.mean(np.abs(a - b) > 1e-3) < 1e-4
