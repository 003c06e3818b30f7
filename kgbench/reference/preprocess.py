"""Plain reference of the host preprocessing of an image: OpenCV's
``INTER_LINEAR`` resize of a uint8 image (pixel centres aligned; the
source positions in float32, 11-bit fixed-point weights, the horizontal
pass exact in integers, the vertical one as OpenCV's vector code rounds
it, so that the result is OpenCV's to the bit) and a zero pad to the
canvas at the bottom and right."""
from __future__ import annotations

import numpy as np


def _axis(src, dst, clamp):
    """Source indices (i0, i1) and fraction of each output position along
    one axis; only the horizontal axis moves positions outside the image
    onto its edge (the vertical one clamps the rows and keeps the
    weights)."""
    pos = ((np.arange(dst, dtype=np.float64) + 0.5) * (src / dst)
           - 0.5).astype(np.float32)
    i0 = np.floor(pos).astype(np.int64)
    frac = pos - i0.astype(np.float32)
    if clamp:
        edge = (i0 < 0) | (i0 >= src - 1)
        frac[edge] = 0
        i0 = np.clip(i0, 0, src - 1)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), frac


def resize_bilinear_u8(img, h, w):
    """(H, W, 3) uint8 -> (h, w, 3) uint8."""
    H, W = img.shape[:2]
    if (H, W) == (h, w):
        return img.copy()
    x0, x1, fx = _axis(W, w, clamp=True)
    y0, y1, fy = _axis(H, h, clamp=False)

    def fixed(f):
        one = np.float32(1)
        return (np.rint((one - f) * np.float32(2048)).astype(np.int32),
                np.rint(f * np.float32(2048)).astype(np.int32))
    ax0, ax1 = fixed(fx)
    by0, by1 = fixed(fy)
    src = img.astype(np.int32)
    hor = (src[:, x0] * ax0[None, :, None] + src[:, x1] * ax1[None, :, None]
           ) >> 4
    out = ((hor[y0] * by0[:, None, None]) >> 16) \
        + ((hor[y1] * by1[:, None, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def pad(img, canvas):
    out = np.zeros(tuple(canvas) + img.shape[2:], img.dtype)
    out[:img.shape[0], :img.shape[1]] = img
    return out
