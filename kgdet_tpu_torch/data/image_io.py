"""Image reading and bilinear resizing for the port, with or without OpenCV.

The JAX package reads and resizes every image with OpenCV (``cv2.imread``,
``cv2.resize(..., INTER_LINEAR)``). A GPU host the port runs on may have
no OpenCV, so this module gives the same arrays either way. The backend is
chosen once, at import, and named by ``BACKEND``:

- ``'cv2'``: OpenCV imports, and every function calls it (a CPU run then
  equals the JAX package array for array);
- ``'numpy'``: the module's own code, NumPy and ``zlib`` only:
  - ``imread``: PNG (8-bit grey, grey + alpha, RGB, RGBA, palette;
    non-interlaced; the five filter types) and binary PPM / PGM (maxval
    255). Anything else (JPEG, 16-bit, interlaced PNG) raises an error that
    names ``cv2``: it never returns a wrong array.
  - ``imresize``: OpenCV's ``INTER_LINEAR``. uint8 runs OpenCV's fixed-point
    arithmetic (11-bit coefficients from float32 source positions, the
    horizontal pass exact in integers, the vertical pass as its vector code
    does it: ``((row >> 4) * beta) >> 16`` per row, summed, ``+ 2 >> 2``).
    float32 runs the lerp ``a + (b - a) * f`` with one rounding, as a fused
    multiply-add gives it, on float32 coefficients taken from float64
    source positions; float64 the same lerp on float64 coefficients in
    extended precision.

``write_png`` writes an 8-bit RGB PNG with NumPy and ``zlib`` whatever the
backend (the synthetic sets of ``chip_smoke.py`` and the GPU tests).

``tests/test_torch_data.py`` holds the NumPy functions (``np_imread``,
``np_imresize``) against OpenCV.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Tuple

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

BACKEND = 'cv2' if cv2 is not None else 'numpy'


class ImageDecodeError(ValueError):
    """A file that the port's own reader does not decode."""


def _unsupported(path, what):
    return ImageDecodeError(
        f'{path}: {what} is not read by the port\'s own image reader '
        f'(PNG 8-bit non-interlaced, binary PPM/PGM); install OpenCV (cv2) '
        f'to read it')


# -------------------------------------------------------------------- read
def imread(path: str) -> np.ndarray:
    """(H, W, 3) uint8 BGR, as ``cv2.imread(path, cv2.IMREAD_COLOR)``.
    Where OpenCV returns None, raises FileNotFoundError for a missing file
    and ImageDecodeError for one it cannot decode."""
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            if not os.path.isfile(path):
                raise FileNotFoundError(path)
            raise ImageDecodeError(f'{path}: cv2 could not decode it')
        return img
    return np_imread(path)


def np_imread(path: str) -> np.ndarray:
    """The NumPy reader behind ``imread``."""
    try:
        with open(path, 'rb') as f:
            data = f.read()
    except OSError as e:
        raise FileNotFoundError(path) from e
    if data[:8] == b'\x89PNG\r\n\x1a\n':
        return _decode_png(data, path)
    if data[:2] in (b'P5', b'P6'):
        return _decode_pnm(data, path)
    raise _unsupported(path, f'a file starting {data[:4]!r}')


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ImageDecodeError(f'{path}: PNG image data has {rows.size} '
                               f'bytes, expected {h * (stride + 1)}')
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:                    # Sub: a running sum per byte lane
            pad = -stride % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)])
            cur = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif ftype == 2:                    # Up
            cur = line + prev
        elif ftype in (3, 4):               # Average, Paeth: sequential
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if ftype == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i],
                                  up[i - bpp] if i >= bpp else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ImageDecodeError(f'{path}: PNG filter type {ftype}')
        out[y] = cur
        prev = out[y]
    return out


def _decode_png(data: bytes, path) -> np.ndarray:
    pos, idat, palette, header = 8, [], None, None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif ctype == b'PLTE':
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b'IDAT':
            idat.append(body)
        elif ctype == b'IEND':
            break
    if header is None:
        raise ImageDecodeError(f'{path}: PNG without IHDR')
    w, h, depth, color, _, _, interlace = header
    if depth != 8:
        raise _unsupported(path, f'a {depth}-bit PNG')
    if interlace:
        raise _unsupported(path, 'an interlaced PNG')
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if channels is None:
        raise _unsupported(path, f'PNG color type {color}')
    px = _unfilter(zlib.decompress(b''.join(idat)), h, w * channels,
                   channels, path).reshape(h, w, channels)
    if color == 3:
        if palette is None:
            raise ImageDecodeError(f'{path}: palette PNG without PLTE')
        rgb = palette[np.minimum(px[..., 0], len(palette) - 1)]
    elif color in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _decode_pnm(data: bytes, path) -> np.ndarray:
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b'#':
            pos = data.index(b'\n', pos) + 1
            continue
        end = pos
        while end < len(data) and not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise _unsupported(path, f'a PNM file with maxval {maxval}')
    channels = 3 if data[:2] == b'P6' else 1
    pos += 1                                  # one whitespace byte
    px = np.frombuffer(data, np.uint8, count=h * w * channels, offset=pos)
    px = px.reshape(h, w, channels)
    if channels == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., ::-1])


# ------------------------------------------------------------------- write
def write_png(path: str, bgr: np.ndarray):
    """(H, W, 3) uint8 BGR -> an 8-bit RGB PNG, rows filtered None / Sub /
    Up in turn, NumPy and ``zlib`` only (for synthetic sets on a host
    without OpenCV; ``imread`` and ``cv2.imread`` read it back
    unchanged)."""
    rgb = np.ascontiguousarray(bgr[..., ::-1]).reshape(bgr.shape[0], -1)
    rows, prev = [], np.zeros(rgb.shape[1], np.uint8)
    for y, line in enumerate(rgb):
        kind = y % 3
        if kind == 1:
            line_f = line - np.concatenate([np.zeros(3, np.uint8), line[:-3]])
        elif kind == 2:
            line_f = line - prev
        else:
            line_f = line
        rows.append(bytes([kind]) + line_f.tobytes())
        prev = line

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack(
            '>IIBBBBB', bgr.shape[1], bgr.shape[0], 8, 2, 0, 0, 0)) +
            chunk(b'IDAT', zlib.compress(b''.join(rows), 1)) +
            chunk(b'IEND', b''))


# ------------------------------------------------------------------ resize
def imresize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)``; size is
    (width, height)."""
    if cv2 is not None:
        return cv2.resize(img, tuple(size), interpolation=cv2.INTER_LINEAR)
    return np_imresize(img, size)


def _axis_coeffs(src: int, dst: int, f64: bool, clamp: bool):
    """Source indices (i0, i1) and fraction f of each output position along
    one axis. OpenCV takes the position as float32 for its fixed-point
    (uint8) path and as float64 otherwise; only the horizontal axis moves
    positions outside the image onto its edge (the vertical one clamps the
    row indices and keeps the weights)."""
    pos = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    if not f64:
        pos = pos.astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0.astype(pos.dtype)
    if clamp:
        edge = (i0 < 0) | (i0 >= src - 1)
        frac[edge] = 0
        i0 = np.clip(i0, 0, src - 1)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), frac


def np_imresize(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """The NumPy resize behind ``imresize`` (uint8, float32, float64)."""
    w, h = int(size[0]), int(size[1])
    if img.dtype not in (np.uint8, np.float32, np.float64):
        raise TypeError(f'imresize: dtype {img.dtype} is not supported '
                        '(uint8, float32, float64)')
    H, W = img.shape[:2]
    x = img.reshape(H, W, -1)
    if (W, H) == (w, h):
        out = x.copy()
    elif img.dtype == np.uint8:
        out = _linear_u8(x, w, h)
    else:
        out = _linear_float(x, w, h)
    # like OpenCV, a single channel comes back as (h, w)
    return out.reshape((h, w) + out.shape[2:]) if out.shape[2] > 1 \
        else out.reshape(h, w)


def _linear_u8(x, w, h):
    H, W, _ = x.shape
    x0, x1, fx = _axis_coeffs(W, w, f64=False, clamp=True)
    y0, y1, fy = _axis_coeffs(H, h, f64=False, clamp=False)
    one = np.float32(1)
    ax0 = np.rint((one - fx) * np.float32(2048)).astype(np.int32)
    ax1 = np.rint(fx * np.float32(2048)).astype(np.int32)
    by0 = np.rint((one - fy) * np.float32(2048)).astype(np.int32)
    by1 = np.rint(fy * np.float32(2048)).astype(np.int32)
    rows_needed = np.unique(np.concatenate([y0, y1]))
    src = x[rows_needed].astype(np.int32)
    # the horizontal pass, exact: at most 255 * 2048 per value
    hor = (src[:, x0] * ax0[None, :, None] + src[:, x1] * ax1[None, :, None])
    hor >>= 4
    where = np.searchsorted(rows_needed, np.stack([y0, y1]))
    out = (hor[where[0]] * by0[:, None, None]) >> 16
    out += (hor[where[1]] * by1[:, None, None]) >> 16
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _linear_float(x, w, h):
    H, W, _ = x.shape
    x0, x1, fx = _axis_coeffs(W, w, f64=True, clamp=True)
    y0, y1, fy = _axis_coeffs(H, h, f64=True, clamp=False)
    if x.dtype == np.float32:
        fx, fy, wide = fx.astype(np.float32), fy.astype(np.float32), np.float64
    else:
        wide = np.longdouble

    def lerp(a, b, f):           # a + (b - a) * f, rounded once
        diff = (b - a).astype(wide)
        return (diff * f.astype(wide) + a.astype(wide)).astype(x.dtype)

    hor = lerp(x[:, x0], x[:, x1], fx[None, :, None])
    return lerp(hor[y0], hor[y1], fy[:, None, None])

