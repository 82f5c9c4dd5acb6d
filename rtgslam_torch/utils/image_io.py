"""Image files and resizes in numpy, in place of the JAX package's ``cv2``.

The JAX package decodes and writes frames with OpenCV
(``data/camera.py:169-212``, ``data/synthetic.py:255-268``,
``data/dataset.py:59,254``, ``slam/eval.py:77-87``).  The port runs where
only numpy, scipy, PyTorch and PyYAML are sure to exist, so this module
holds what those calls did:

- ``read_png`` / ``write_png``: PNG with zlib and numpy.  The reader takes
  8-bit gray, gray+alpha, RGB and RGBA and 16-bit of the same, not
  interlaced, all five row filters (OpenCV writes adaptive filters, and so
  do TUM and ScanNet++ depth PNGs).  The writer emits filter 0 only.
- ``imread``: PNG here, JPEG through ``cv2`` or PIL where one of them is
  installed (an optional reader dependency).  Color comes back RGB.
- ``resize_area`` / ``resize_nearest``: ``cv2.resize`` with INTER_AREA
  (downscale) and INTER_NEAREST.
- ``apply_jet``: OpenCV's JET colormap on uint8, as BGR, to within one
  level.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG color type -> samples per pixel


def _chunks(raw: bytes, path: str):
    if raw[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(raw):
        length, kind = struct.unpack(">I4s", raw[pos:pos + 8])
        yield kind, raw[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _header(raw: bytes, path: str):
    kind, data = next(_chunks(raw, path))
    if kind != b"IHDR":
        raise ValueError(f"{path}: PNG without IHDR")
    return struct.unpack(">IIBBBBB", data[:13])


def _unfilter(filt: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters.  ``filt`` [H, W, bpp] uint8 holds the
    filtered bytes, ``kinds`` [H] each row's filter (0 None, 1 Sub, 2 Up,
    3 Average, 4 Paeth).  Average and Paeth depend on the left neighbour
    of the same row, so they are undone along anti-diagonals: pixel (r, x)
    needs (r, x-1), (r-1, x) and (r-1, x-1), all on earlier diagonals, so
    H + W - 1 vectorized steps cover the image whatever the mix of filters."""
    H, W, _ = filt.shape
    if not kinds.any():
        return filt
    if np.isin(kinds, (0, 1, 2)).all():
        out = np.empty_like(filt)
        prev = np.zeros((W, bpp), np.uint8)
        for r in range(H):
            k = kinds[r]
            if k == 1:
                row = np.cumsum(filt[r], axis=0, dtype=np.uint8)
            elif k == 2:
                row = filt[r] + prev
            else:
                row = filt[r]
            out[r] = prev = row
        return out
    # padded reconstruction: row 0 and column 0 are the zero border
    rec = np.zeros((H + 1, W + 1, bpp), np.int32)
    f32 = filt.astype(np.int32)
    k_all = kinds.astype(np.int32)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H, d + 1))
        x = d - r
        a = rec[r + 1, x]          # left
        b = rec[r, x + 1]          # up
        c = rec[r, x]              # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = k_all[r][:, None]
        pred = np.where(k == 1, a, np.where(
            k == 2, b, np.where(k == 3, (a + b) >> 1, np.where(k == 4, paeth, 0))))
        rec[r + 1, x + 1] = (f32[r, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: [H, W] for gray, [H, W, C] otherwise (RGB / RGBA /
    gray+alpha), uint8 or uint16 (16-bit samples are big endian on disk)."""
    with open(path, "rb") as f:
        raw = f.read()
    W, H, depth, ctype, _, _, interlace = _header(raw, path)
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: PNG color type {ctype}, bit depth {depth}, "
                         f"interlace {interlace} is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    data = zlib.decompress(b"".join(d for k, d in _chunks(raw, path)
                                    if k == b"IDAT"))
    rows = np.frombuffer(data, np.uint8)[:H * (W * bpp + 1)].reshape(H, W * bpp + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: bad PNG filter type {int(kinds.max())}")
    pix = _unfilter(rows[:, 1:].reshape(H, W, bpp), kinds, bpp)
    if depth == 16:
        pix = pix.reshape(H, W * ch, 2)
        pix = (pix[..., 0].astype(np.uint16) << 8) | pix[..., 1]
    pix = pix.reshape(H, W, ch)
    return pix[..., 0] if ch == 1 else np.ascontiguousarray(pix)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write uint8 or uint16 [H, W] (gray) or [H, W, 3|4] (RGB / RGBA) as a
    PNG with filter 0 on every row."""
    img = np.asarray(image)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png takes uint8 or uint16, not {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    H, W = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    body = img.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1).view(np.uint8)
    rows = np.concatenate([np.zeros((H, 1), np.uint8), body], axis=1)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _read_jpeg(path: str) -> np.ndarray:
    """JPEG through cv2 or PIL, whichever is installed (RGB out)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img if img.ndim == 2 else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path}: decoding JPEG needs cv2 or PIL, and "
                          "neither is installed") from None
    with Image.open(path) as im:
        return np.asarray(im)


def imread(path: str) -> np.ndarray:
    """Decode an image file as ``cv2.imread(path, IMREAD_UNCHANGED)`` does,
    with color in RGB order."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        sig = f.read(8)
    if sig == _PNG_SIG:
        return read_png(path)
    return _read_jpeg(path)


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of an image file; a PNG is read from its header."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] == _PNG_SIG:
        W, H = _header(head, path)[:2]
        return H, W
    return imread(path).shape[:2]


# ---------------------------------------------------------------------------
# resizes (cv2.resize semantics)
# ---------------------------------------------------------------------------

def _area_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] INTER_AREA weights of a downscale (OpenCV's
    ``computeResizeAreaTab``): each output cell averages the input cells it
    covers, partly covered ones by their covered fraction."""
    scale = 1.0 / (dst / src)      # OpenCV's 1 / inv_scale
    w = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = (sx1 - fsx1) / cell
        w[dx, sx1:sx2] = 1.0 / cell
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
    return w


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_AREA)`` for a
    float32 [H, W] or [H, W, C] downscale."""
    H, W = img.shape[:2]
    if width > W or height > H:
        raise ValueError("resize_area only downscales")
    wy, wx = _area_weights(H, height), _area_weights(W, width)
    x = img.astype(np.float64)
    out = np.einsum("yh,hw...->yw...", wy, x)
    out = np.einsum("xw,yw...->yx...", wx, out)
    return out.astype(img.dtype)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_NEAREST)``:
    source index floor(dst * (1 / (dst_size / src_size)))."""
    H, W = img.shape[:2]
    fx, fy = 1.0 / (width / W), 1.0 / (height / H)
    xs = np.minimum(np.floor(np.arange(width) * fx).astype(np.int64), W - 1)
    ys = np.minimum(np.floor(np.arange(height) * fy).astype(np.int64), H - 1)
    return img[ys][:, xs]


# ---------------------------------------------------------------------------
# colormap
# ---------------------------------------------------------------------------

def apply_jet(gray: np.ndarray) -> np.ndarray:
    """OpenCV's COLORMAP_JET on uint8 [H, W]: uint8 [H, W, 3] in BGR order
    (piecewise-linear jet; within one level of ``cv2.applyColorMap``)."""
    x = np.arange(256) / 255.0
    lut = np.stack([np.clip(1.5 - np.abs(4.0 * x - c), 0.0, 1.0)
                    for c in (1.0, 2.0, 3.0)], axis=-1)
    lut = np.round(lut * 255.0).astype(np.uint8)
    return lut[np.asarray(gray, np.uint8)]
