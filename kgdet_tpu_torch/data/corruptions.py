"""Image corruption transforms for robustness benchmarking.

Self-contained NumPy/OpenCV implementations of the common corruption
benchmark families (noise / blur / digital / weather-lite), severity 1-5.
The reference delegates to the external `imagecorruptions` package
(mmdet/datasets/custom.py:204-209, tools/test_robustness.py); this module
removes that dependency while keeping the same call surface:
``corrupt(img, corruption_name, severity)`` on BGR uint8 images.

Port of kgdet_tpu/data/corruptions.py, output for output the same under the
same cv2: the noise is drawn from a NumPy ``RandomState`` seeded by a hash
of the pixels (``_rng``). The blurs, ``jpeg_compression`` and ``pixelate``
call cv2 when they run; ``image_io.require_cv2`` names it where it does not
import. The noise families, ``brightness`` and ``contrast`` are NumPy only.
"""
from __future__ import annotations

import numpy as np

from kgdet_tpu_torch.data.image_io import require_cv2


def _rng(img):
    # deterministic per-image noise: seed from a cheap content hash
    return np.random.RandomState(int(img[::7, ::7].sum()) % (2 ** 31))


def gaussian_noise(img, severity):
    c = [0.04, 0.06, 0.08, 0.09, 0.10][severity - 1] * 255
    x = img.astype(np.float32) + _rng(img).normal(0, c, img.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def shot_noise(img, severity):
    c = [500, 250, 100, 75, 50][severity - 1]
    x = img.astype(np.float32) / 255.0
    x = _rng(img).poisson(x * c) / float(c)
    return np.clip(x * 255, 0, 255).astype(np.uint8)


def impulse_noise(img, severity):
    c = [0.01, 0.02, 0.03, 0.05, 0.07][severity - 1]
    rng = _rng(img)
    out = img.copy()
    mask = rng.rand(*img.shape[:2])
    out[mask < c / 2] = 0
    out[mask > 1 - c / 2] = 255
    return out


def defocus_blur(img, severity):
    cv2 = require_cv2('defocus_blur')
    c = [3, 4, 6, 8, 10][severity - 1]
    kernel = np.zeros((2 * c + 1, 2 * c + 1), np.float32)
    cv2.circle(kernel, (c, c), c, 1, -1)
    kernel /= kernel.sum()
    return cv2.filter2D(img, -1, kernel)


def motion_blur(img, severity):
    cv2 = require_cv2('motion_blur')
    c = [5, 7, 9, 13, 17][severity - 1]
    kernel = np.zeros((c, c), np.float32)
    kernel[c // 2, :] = 1.0 / c
    rot = cv2.getRotationMatrix2D((c / 2 - 0.5, c / 2 - 0.5), 45, 1)
    kernel = cv2.warpAffine(kernel, rot, (c, c))
    s = kernel.sum()
    if s > 0:
        kernel /= s
    return cv2.filter2D(img, -1, kernel)


def gaussian_blur(img, severity):
    cv2 = require_cv2('gaussian_blur')
    c = [1, 2, 3, 4, 6][severity - 1]
    return cv2.GaussianBlur(img, (0, 0), c)


def brightness(img, severity):
    c = [0.1, 0.2, 0.3, 0.4, 0.5][severity - 1]
    return np.clip(img.astype(np.float32) + c * 255, 0, 255).astype(np.uint8)


def contrast(img, severity):
    c = [0.75, 0.5, 0.4, 0.3, 0.15][severity - 1]
    mean = img.mean(axis=(0, 1), keepdims=True)
    return np.clip((img - mean) * c + mean, 0, 255).astype(np.uint8)


def jpeg_compression(img, severity):
    cv2 = require_cv2('jpeg_compression')
    c = [80, 65, 58, 50, 40][severity - 1]
    ok, enc = cv2.imencode('.jpg', img,
                           [int(cv2.IMWRITE_JPEG_QUALITY), c])
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)


def pixelate(img, severity):
    cv2 = require_cv2('pixelate')
    c = [0.6, 0.5, 0.4, 0.3, 0.25][severity - 1]
    h, w = img.shape[:2]
    small = cv2.resize(img, (max(int(w * c), 1), max(int(h * c), 1)),
                       interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


CORRUPTIONS = {
    'gaussian_noise': gaussian_noise,
    'shot_noise': shot_noise,
    'impulse_noise': impulse_noise,
    'defocus_blur': defocus_blur,
    'motion_blur': motion_blur,
    'gaussian_blur': gaussian_blur,
    'brightness': brightness,
    'contrast': contrast,
    'jpeg_compression': jpeg_compression,
    'pixelate': pixelate,
}


def corrupt(img, corruption_name, severity=1):
    """Apply a named corruption (severity 1-5) to a BGR uint8 image."""
    if not 1 <= severity <= 5:
        raise ValueError(f'severity must be 1..5, got {severity}')
    if corruption_name not in CORRUPTIONS:
        raise KeyError(f'unknown corruption {corruption_name!r}; '
                       f'have {sorted(CORRUPTIONS)}')
    return CORRUPTIONS[corruption_name](img, severity)
