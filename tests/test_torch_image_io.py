"""The port's image files and resizes (``rtgslam_torch/utils/image_io.py``)
against OpenCV, which the JAX package uses for the same jobs.

- PNG reader: equal to ``cv2.imread(IMREAD_UNCHANGED)`` (color converted
  to RGB), exactly, on files ``cv2.imwrite`` wrote: 8-bit RGB, RGBA and
  gray, 16-bit depth, each with OpenCV's default filter choice, all
  filters (adaptive) and each of Sub / Up / Average / Paeth forced.
- PNG writer: its files decode under ``cv2`` to the array written.
- Resizes: INTER_NEAREST equal; INTER_AREA within 2.4e-7 (OpenCV sums in
  float32, the port in float64; measured 1.2e-7 on values in [0, 1]).
- JET: within one level of ``cv2.applyColorMap``.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from rtgslam_torch.utils import image_io

torch.set_num_threads(1)

_FILTERS = {
    "default": [],
    "all": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS],
    "sub": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_SUB],
    "up": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_UP],
    "avg": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_AVG],
    "paeth": [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_FILTER_PAETH],
}


def _images(H=61, W=97):
    """Smooth gradients with noise and a band of pure noise, so adaptive
    filtering picks every filter type somewhere."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    rgb = np.stack([np.sin(xx / 7.0) * 110 + 128, np.cos(yy / 5.0) * 90 + 128,
                    (3 * xx + 2 * yy) % 256], -1)
    rgb = (rgb + rng.integers(0, 6, rgb.shape)).clip(0, 255).astype(np.uint8)
    rgb[20:30] = rng.integers(0, 256, (10, W, 3))
    depth = (np.abs(np.sin(xx / 9.0)) * 3000 + yy * 40
             + rng.integers(0, 3, (H, W))).astype(np.uint16)
    return {"rgb": rgb, "rgba": np.dstack([rgb, rgb[..., 1:2]]),
            "gray": rgb[..., 0].copy(), "depth16": depth}


def _cv2_read(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[2] == 4
                           else cv2.COLOR_BGR2RGB)
    return img


def _cv2_write(path, img, params):
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGBA2BGRA if img.shape[2] == 4
                           else cv2.COLOR_RGB2BGR)
    assert cv2.imwrite(path, img, params)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "depth16"])
@pytest.mark.parametrize("filt", sorted(_FILTERS))
def test_png_reader_equals_cv2(tmp_path, kind, filt):
    img = _images()[kind]
    path = str(tmp_path / f"{kind}_{filt}.png")
    _cv2_write(path, img, _FILTERS[filt])
    got = image_io.imread(path)
    ref = _cv2_read(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)
    assert image_io.image_size(path) == img.shape[:2]


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "depth16"])
def test_png_writer_decodes_under_cv2(tmp_path, kind):
    img = _images()[kind]
    path = str(tmp_path / f"{kind}.png")
    image_io.write_png(path, img)
    np.testing.assert_array_equal(_cv2_read(path), img)
    np.testing.assert_array_equal(image_io.read_png(path), img)


def test_jpeg_goes_through_an_installed_codec(tmp_path):
    img = _images()["rgb"]
    path = str(tmp_path / "frame.jpg")
    _cv2_write(path, img, [])
    np.testing.assert_array_equal(image_io.imread(path), _cv2_read(path))


@pytest.mark.parametrize("shape", [(68, 120, 3), (47, 63, 3), (46, 62)])
@pytest.mark.parametrize("scale", [2, 4, 8])
def test_resizes_equal_cv2(shape, scale):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    new_w, new_h = round(shape[1] / scale), round(shape[0] / scale)
    area = image_io.resize_area(img, new_w, new_h)
    ref = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_AREA)
    assert area.shape == ref.shape and area.dtype == np.float32
    np.testing.assert_allclose(area, ref, rtol=0, atol=2.4e-7)
    np.testing.assert_array_equal(
        image_io.resize_nearest(img, new_w, new_h),
        cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_NEAREST))


def test_jet_within_one_level_of_cv2():
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    ref = cv2.applyColorMap(gray, cv2.COLORMAP_JET).astype(int)
    assert np.abs(image_io.apply_jet(gray).astype(int) - ref).max() <= 1


def test_unsupported_png_raises(tmp_path):
    path = str(tmp_path / "pal.png")
    img = _images()["gray"]
    image_io.write_png(path, img)
    raw = bytearray(open(path, "rb").read())
    raw[24] = 4         # bit depth 4 in IHDR (CRC left stale: never checked)
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError):
        image_io.read_png(path)
    assert not os.path.exists(str(tmp_path / "missing.png"))
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "missing.png"))
