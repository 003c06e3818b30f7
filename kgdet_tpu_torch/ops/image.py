"""Device-side image normalization for uint8-shipped batches.

Port of kgdet_tpu/ops/image.py: the host ships raw uint8 BGR images and
BGR->RGB, (x - mean) / std and the re-zeroing of the padded margin run on
the device. Other dtypes pass through untouched.
"""
from __future__ import annotations

import torch

from kgdet_tpu.data.deepfashion2_meta import IMG_MEAN, IMG_STD


def device_normalize(img, extents=None):
    """(B, H, W, 3) uint8 BGR -> normalized f32 RGB; other dtypes pass
    through. ``extents`` (B, 2) valid (h, w) re-zeroes the padded margin
    (parity with the host path, which zero-pads after normalizing)."""
    if img.dtype != torch.uint8:
        return img
    x = img.flip(-1).float()
    mean = torch.as_tensor(IMG_MEAN, dtype=torch.float32, device=img.device)
    std = torch.as_tensor(IMG_STD, dtype=torch.float32, device=img.device)
    x = (x - mean) / std
    if extents is not None:
        H, W = x.shape[1], x.shape[2]
        ext = extents.to(device=img.device, dtype=torch.float32)
        row = torch.arange(H, dtype=torch.float32,
                           device=img.device)[None, :] < ext[:, 0:1]
        col = torch.arange(W, dtype=torch.float32,
                           device=img.device)[None, :] < ext[:, 1:2]
        x = x * (row[:, :, None, None] & col[:, None, :, None])
    return x
