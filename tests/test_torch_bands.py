"""Port parity: the row-band path (``rtgslam_torch/data/bands.py``,
``Camera.get_uv``, ``slam/run.py::track_and_map_banded`` / ``eval_banded``
and ``slam_torch.py --bands``) against the JAX package's
``data/bands.py``, ``Camera.get_uv`` and ``slam.py``'s banded loop.

The split and the downsample are numpy in both packages: arrays, poses
and names equal, intrinsics and fields of view equal to float32 rounding
(1e-6), the principal points of the lower bands (0 and below) included.

The banded loop in process, forward-only (both iteration counts 0) at
96x128 x 6 frames, 2 bands, tracking at stride 2 (48x64): the JAX side is
:func:`torch_parity.run_jax_sequence` with the zero-iteration mapper.
Measured on the CPU (torch 2.13, jax 0.9): poses 1.6e-5, gaussian counts
equal; held to the forward-only tolerances of ``test_torch_slice.py``
(poses 1e-4, ATE 1e-3 cm, PSNR 0.01 dB, depth L1 0.01 cm, counts 1 %).

The entry point, ``slam_torch.py --bands 2`` then ``metric_torch.py``, at
96x128 x 6 on the room written to disk, against
``tests/data/entry_bands_96x128_jax_cpu.json`` (``slam.py`` + ``metric.py``
on the CPU with the child config its ``overrides`` name):

    JAX_PLATFORMS=cpu python tests/torch_parity.py --entry --bands 2 --frames 6 --height 96 --width 128

With gradient passes, Adam (eps 1e-15) turns rounding differences into
lr-sized steps (``test_torch_entry.py``); at this size tracking on the
48x64 stride-2 copy turns them into pose gaps of 8.3e-3 at frame 1, and
the JAX run on the frames from disk loses track (ROADMAP.md §3, F5).  So the
entry reference tracks at stride 1 (``BAND_ENTRY``): the bands, the band
keyframes, the windowed global pass over band cameras and the banded
final eval stay on its path, and stride 2 is held forward-only above and
at 340x600 on the card (``chip_smoke.py`` phase 10a).  Tolerances are
``test_torch_entry.py``'s: poses 1e-3, ATE 0.05 cm, PSNR and the CSV's
mean PSNR 0.2 dB, depth L1 0.01 cm, checkpoint rows within 2 % of the map,
file sets name for name; the banded line's depth L1 is printed to 0.01, so
it is held to 0.01 plus one printed unit, and its PSNR to ``chip_smoke.py``'s
``ENTRY_REF_TOL`` final_psnr, 0.8 dB (that frame's bands are scored after
the windowed global call and the final pass; measured 0.22).
"""

import contextlib
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from rtgslam_tpu.data import bands as jbands
from rtgslam_torch.data import bands as tbands

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parity as tp  # noqa: E402

torch.set_num_threads(1)
REF = tp.reference_name(96, 128, bands=2)
REF_STRIDE2 = os.path.join(tp.REPO, "tests", "data",
                           "entry_bands_96x128_stride2_jax_cpu.json")
TOL = {"poses": 1e-3, "ate_cm": 0.05, "psnr": 0.2, "depth_l1_cm": 0.01,
       "rows_rel": 0.02, "unit": 0.01, "banded_psnr": 0.8,
       "banded_depth_l1_cm": 0.02}
FWD_TOL = {"poses": 1e-4, "ate_cm": 1e-3, "psnr": 0.01, "depth_l1_cm": 0.01,
           "counts_rel": 0.01}
SPLITS = [(n, r) for n in (1, 2, 4) for r in range(n)]


def _port_cam(cam):
    return tp.port_cameras([cam])[0]


def _same_camera(got, want):
    assert got.uid == want.uid and got.image_name == want.image_name
    assert (got.image_height, got.image_width) == (want.image_height,
                                                   want.image_width)
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.depth, want.depth)
    np.testing.assert_array_equal(got.R, want.R)
    np.testing.assert_array_equal(got.T, want.T)
    assert got.FoVx == want.FoVx
    assert got.FoVy == pytest.approx(want.FoVy, rel=1e-12, abs=0)
    assert got.cx == want.cx and got.cy == want.cy
    np.testing.assert_allclose(got.intrinsic, want.intrinsic, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n,rotate", SPLITS)
def test_split_bands_matches_jax(synthetic_cams, n, rotate):
    cam = synthetic_cams[0]
    want = jbands.split_bands(cam, n, rotate=rotate)
    got = tbands.split_bands(_port_cam(cam), n, rotate=rotate)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        _same_camera(g, w)
    if n > 1:   # band (k + rotate) % n comes k-th, its cy at or below 0 low down
        order = [(k + rotate) % n for k in range(n)]
        bh = cam.image_height // n
        assert [b.image_name for b in got] == [f"{cam.image_name}#band{b}"
                                               for b in order]
        assert [b.cy for b in got] == [cam.cy - b * bh for b in order]
        assert min(b.cy for b in got) <= 0


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_downsample_camera_matches_jax(synthetic_cams, stride):
    cam = synthetic_cams[1]
    pcam = _port_cam(cam)
    got = tbands.downsample_camera(pcam, stride)
    _same_camera(got, jbands.downsample_camera(cam, stride))
    if stride == 1:
        assert got is pcam          # as in JAX: the same object
    assert tbands.downsample_camera(pcam, stride, uid=7).uid == (
        jbands.downsample_camera(cam, stride, uid=7).uid)


@pytest.mark.parametrize("n", [5, 7])
def test_split_bands_refuses_uneven_heights(synthetic_cams, n):
    cam = synthetic_cams[0]
    with pytest.raises(ValueError) as want:
        jbands.split_bands(cam, n)
    with pytest.raises(ValueError) as got:
        tbands.split_bands(_port_cam(cam), n)
    assert str(got.value) == str(want.value)


def _lifted_pixels(cam):
    """A grid of valid-depth pixels of ``cam`` lifted to world points
    (``tests/test_bands.py``)."""
    d = np.asarray(cam.depth[..., 0])
    vs, us = np.nonzero(d > 0.1)
    pick = slice(0, len(vs), max(1, len(vs) // 200))
    vs, us = vs[pick], us[pick]
    K = cam.intrinsic
    pts_c = np.stack([(us + 0.5 - K[0, 2]) / K[0, 0] * d[vs, us],
                      (vs + 0.5 - K[1, 2]) / K[1, 1] * d[vs, us],
                      d[vs, us]], axis=1)
    c2w = cam.c2w
    return vs, pts_c @ c2w[:3, :3].T + c2w[:3, 3]


def test_band_projection_identity(synthetic_cams):
    """The port's twin of ``test_bands.py::test_band_projection_identity``:
    a world point on pixel (u, v) of the frame lands on (u, v - r0) of the
    band holding row v, through ``Camera.get_uv``."""
    cam = _port_cam(synthetic_cams[0])
    H, n = cam.image_height, 4
    bands = tbands.split_bands(cam, n)
    assert [b.image_height for b in bands] == [H // n] * n
    vs, pts_w = _lifted_pixels(cam)
    uv_full = cam.get_uv(pts_w)
    bh = H // n
    for b, band in enumerate(bands):
        rows = (vs >= b * bh) & (vs < (b + 1) * bh)
        assert rows.any()
        uv_band = band.get_uv(pts_w[rows])
        assert np.array_equal(uv_band[:, 0], uv_full[rows][:, 0])
        assert np.array_equal(uv_band[:, 1], uv_full[rows][:, 1] - b * bh)


def test_get_uv_matches_jax(synthetic_cams):
    """``Camera.get_uv`` equals the JAX package's, on the frame and on each
    band (their principal points at and below row 0 included)."""
    cam = synthetic_cams[2]
    _, pts_w = _lifted_pixels(cam)
    for jc, pc in zip([cam] + jbands.split_bands(cam, 2),
                      [_port_cam(cam)] + tbands.split_bands(_port_cam(cam), 2)):
        np.testing.assert_array_equal(pc.get_uv(pts_w), jc.get_uv(pts_w))


def test_downsample_keeps_rays(synthetic_cams):
    """The port's twin of ``test_bands.py::test_downsample_keeps_rays``:
    pixel (u, v) of the strided camera sees the ray of (s*u, s*v) of the
    frame, and its projection lands there."""
    cam = _port_cam(synthetic_cams[0])
    s = 2
    small = tbands.downsample_camera(cam, s)
    assert small.image_height == cam.image_height // s
    d = np.asarray(cam.depth[::s, ::s, 0])
    vs, us = np.nonzero(d > 0.1)
    vs, us = vs[::37], us[::37]
    Ks, Kf = small.intrinsic, cam.intrinsic
    ray_s = np.stack([(us + 0.5 - Ks[0, 2]) / Ks[0, 0],
                      (vs + 0.5 - Ks[1, 2]) / Ks[1, 1]], axis=1)
    ray_f = np.stack([(s * us + 0.5 * s - Kf[0, 2]) / Kf[0, 0],
                      (s * vs + 0.5 * s - Kf[1, 2]) / Kf[1, 1]], axis=1)
    np.testing.assert_allclose(ray_s, ray_f, atol=1e-5)
    np.testing.assert_array_equal(small.depth, cam.depth[::s, ::s])
    # a point on ray (u, v) of the strided camera projects to the full
    # frame's pixel s*(u, v) + (s - 1) / 2 (pixel centres)
    z = d[vs, us]
    pts_c = np.stack([ray_s[:, 0] * z, ray_s[:, 1] * z, z], axis=1)
    c2w = small.c2w
    pts_w = pts_c @ c2w[:3, :3].T + c2w[:3, 3]
    uv = cam.get_uv(pts_w)
    assert np.abs(uv[:, 0] - s * us).max() <= 1
    assert np.abs(uv[:, 1] - s * vs).max() <= 1


def test_ms_ssim_of_a_thin_band_matches_jax():
    """MS-SSIM halves a band under 16 rows to no rows at its coarsest
    scales: NaN in both packages (``slam_torch.py --bands 8`` at 96 rows)."""
    from rtgslam_tpu.models import losses as jlosses
    from rtgslam_torch.models import losses as tlosses

    rng = np.random.default_rng(0)
    a, b = (rng.uniform(size=(12, 128, 3)).astype(np.float32) for _ in range(2))
    want = float(jlosses.ms_ssim(a, b))
    got = float(tlosses.ms_ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert np.isnan(want) and np.isnan(got)


# ---------------------------------------------------------------------------
# the banded loop in process
# ---------------------------------------------------------------------------

def _banded_args(base_args, **kw):
    args = copy.copy(base_args)
    args.tile_capacity = 1024
    args.block_capacity = 4096
    args.use_gt_pose = False
    args.icp_use_model_depth = True
    args.frame_bands = 2
    args.band_track_stride = 2
    for k, v in kw.items():
        setattr(args, k, v)
    return args


@pytest.fixture(scope="module")
def forward_runs(base_args, synthetic_cams):
    from rtgslam_torch.slam.run import run_sequence

    args = _banded_args(base_args, gaussian_update_iter=0, final_global_iter=0)
    H, W = synthetic_cams[0].image.shape[:2]
    ref = tp.run_jax_sequence(args, copy.deepcopy(synthetic_cams))
    out = run_sequence(args, tp.port_cameras(synthetic_cams), "cpu",
                       tp.replay(tp.jax_priorities(len(synthetic_cams) * 2,
                                                   H // 2, W)))
    return ref, out


def test_banded_forward_poses_and_ate(forward_runs):
    ref, out = forward_runs
    np.testing.assert_allclose(out["poses"], ref["poses"], rtol=0,
                               atol=FWD_TOL["poses"])
    assert abs(out["ate_cm"] - ref["ate_cm"]) <= FWD_TOL["ate_cm"]


def test_banded_forward_final_eval(forward_runs):
    ref, out = forward_runs
    for k in ("psnr", "depth_l1_cm"):
        assert abs(out["eval"][k] - ref["eval"][k]) <= FWD_TOL[k], k
    assert out["eval_uid"] == ref["eval_uid"]
    assert len(out["eval"]["bands"]) == 2
    assert out["max_overflow"] == ref["max_overflow"] == 0
    # the feedback renders at the track size, counted apart
    assert out["feedback_overflow"] == ref["feedback_overflow"]


def test_banded_forward_counts_and_schedule(forward_runs):
    ref, out = forward_runs
    for (u, s), (ru, rs) in zip(out["counts"], ref["counts"]):
        assert abs((u + s) - (ru + rs)) <= FWD_TOL["counts_rel"] * (ru + rs)
    mapper = out["mapper"]
    # the clock advances once per band: 2 per frame
    assert mapper.time == 2 * len(out["poses"])
    assert mapper.settings.height == 48 and mapper.settings.width == 128
    assert mapper.n_spawns == 2 * len(out["poses"])
    # keyframes are band cameras, as in JAX
    ref_kf = ref["keyframes"]
    assert [(kf["frame"].uid, kf["frame"].image_name)
            for kf in mapper.keyframe_list] == ref_kf
    assert all("#band" in name for _, name in ref_kf)


def test_banded_run_covers_the_whole_view(base_args, synthetic_cams):
    """The port's twin of ``test_bands.py::test_banded_e2e``'s coverage
    check: with gradient passes, the banded map renders both halves of the
    last frame at full resolution, and tracking stays sub-centimetre."""
    from rtgslam_torch.ops.rasterize import RasterSettings
    from rtgslam_torch.slam.run import run_sequence

    args = _banded_args(base_args)
    cams = tp.port_cameras(synthetic_cams)
    out = run_sequence(args, cams, "cpu")
    mapper = out["mapper"]
    assert out["ate_cm"] < 1.0
    assert mapper.get_unstable_num + mapper.get_stable_num > 500
    full = RasterSettings.from_args(args, cams[-1].image_height,
                                    cams[-1].image_width)
    T = mapper._render(cams[-1].device_dict(), settings=full)["T_map"][..., 0]
    H = T.shape[0]
    assert float((T[: H // 2] < 0.3).float().mean()) > 0.25, "top half uncovered"
    assert float((T[H // 2:] < 0.3).float().mean()) > 0.25, "bottom half uncovered"
    assert out["max_overflow"] == 0


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _entry(tmp_path_factory, path):
    import metric_torch
    import slam_torch
    from rtgslam_torch.data.synthetic import write_scene
    from rtgslam_torch.utils.threefry import jax_priorities

    with open(path) as f:
        ref = json.load(f)
    tmp = tmp_path_factory.mktemp("entry_bands")
    scene = write_scene(str(tmp / "scene"), ref["frames"], ref["height"],
                        ref["width"])
    # the band count comes from the command line, as slam.py --bands gives it
    overrides = {k: v for k, v in ref["overrides"].items() if k != "frame_bands"}
    cfg = tp.write_child_config(str(tmp / "entry.yaml"), tp.reference_parent(ref),
                                scene, str(tmp / "out"), overrides)
    log = tp.Tee()
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(tp.REPO)
        with contextlib.redirect_stdout(log):
            res = slam_torch.main(["--config", cfg, "--device", "cpu",
                                   "--bands", str(ref["banded_n"])],
                                  priority_source=jax_priorities())
        met = metric_torch.main(["--config", cfg, "--device", "cpu"])
    finally:
        mp.undo()
    got = tp.summarize_run(str(tmp / "out"))
    got.update(tp.banded_eval(log.text()))
    return ref, res, met, got, log.text()


@pytest.fixture(scope="module")
def entry_run(tmp_path_factory):
    return _entry(tmp_path_factory, REF)


def test_entry_bands_stride2_files_and_rows(tmp_path_factory):
    """The entry point at the tracking stride 2 of ``room_mid.yaml`` (48x64
    here) against ``tests/data/entry_bands_96x128_stride2_jax_cpu.json``:
    the same files name for name and checkpoint rows within 2 % of the map
    (measured: within 2 %).  Its poses are not held: the JAX run loses
    track (ATE 1.399 cm, the port 0.178; ROADMAP.md §3, F5)."""
    ref, res, _, got, _ = _entry(tmp_path_factory, REF_STRIDE2)
    assert ref["overrides"]["band_track_stride"] == 2
    assert tuple(res["tracker"]._prev_depth.shape[:2]) == (48, 64)
    for k in ("save_model_files", "save_traj_files", "final_eval_file",
              "csv_file", "csv_columns", "csv_rows", "banded_n"):
        assert got[k] == ref[k], k
    assert not tp.rows_within(got["checkpoint_rows"], ref["checkpoint_rows"],
                              TOL["rows_rel"])
    assert res["mapper"].max_overflow == ref["max_overflow"] == 0


def test_entry_bands_trajectory_and_quality(entry_run):
    ref, res, _, got, _ = entry_run
    np.testing.assert_allclose(got["poses"], ref["poses"], rtol=0,
                               atol=TOL["poses"])
    assert abs(got["ate_cm"] - ref["ate_cm"]) <= TOL["ate_cm"]
    assert abs(res["ate_cm"] - got["ate_cm"]) < 1e-9
    assert got["final_eval_file"] == ref["final_eval_file"]
    # the newest eval JSON is the final keyframe's last band, in both
    assert abs(got["psnr"] - ref["psnr"]) <= TOL["psnr"]
    assert abs(got["depth_l1_cm"] - ref["depth_l1_cm"]) <= TOL["depth_l1_cm"]
    assert res["final_eval"]["bands"][-1]["psnr"] == got["psnr"]
    assert res["mapper"].max_overflow == ref["max_overflow"] == 0


def test_entry_bands_banded_final_eval(entry_run):
    ref, res, _, got, log = entry_run
    assert got["banded_n"] == ref["banded_n"] == 2
    for k in ("banded_psnr", "banded_depth_l1_cm"):
        assert abs(got[k] - ref[k]) <= TOL[k], (k, got[k], ref[k])
    ev = res["final_eval"]
    assert f"psnr {ev['psnr']:.2f} depthL1 {ev['depth_l1_cm']:.2f}cm" in log
    mse = np.mean([10 ** (-b["psnr"] / 10) for b in ev["bands"]])
    assert ev["psnr"] == pytest.approx(-10 * np.log10(mse), rel=1e-12)


def test_entry_bands_log_and_schedule(entry_run):
    ref, res, _, _, log = entry_run
    mapper, tracker = res["mapper"], res["tracker"]
    stride = ref["overrides"]["band_track_stride"]
    # tracking at the stride's size, two band mappings per frame
    assert tuple(tracker._prev_depth.shape[:2]) == (ref["height"] // stride,
                                                    ref["width"] // stride)
    assert mapper.time == 2 * ref["frames"]
    assert mapper.settings.height == ref["height"] // 2
    assert log.count("[EVAL] final keyframe (banded x2)") == 1


def test_entry_bands_checkpoints_and_files(entry_run):
    ref, _, _, got, _ = entry_run
    assert got["save_model_files"] == ref["save_model_files"]
    assert got["save_traj_files"] == ref["save_traj_files"]
    assert not tp.rows_within(got["checkpoint_rows"], ref["checkpoint_rows"],
                              TOL["rows_rel"])


def test_entry_bands_metric_csv(entry_run):
    ref, _, met, got, _ = entry_run
    assert got["csv_file"] == ref["csv_file"]
    assert got["csv_columns"] == ref["csv_columns"]
    assert got["csv_rows"] == ref["csv_rows"] == ref["frames"]
    for k, v in ref["csv_mean"].items():
        tol = TOL.get(k, TOL["unit"])
        assert abs(got["csv_mean"][k] - v) <= tol, (k, got["csv_mean"][k], v)
    assert len(met["frame_ms"]) == ref["frames"]
