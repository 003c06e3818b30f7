"""The remaining native-op equivalents: masked conv, deformable RoI pooling.

Port of kgdet_tpu/ops/misc_ops.py.

- ``masked_conv2d``: the reference's CUDA kernel (mmdet/ops/masked_conv)
  convolves only at masked positions to save work for guided anchoring; the
  result equals the dense conv times the mask, which is what runs here.
- ``deform_roi_pooling``: deformable RoI pooling v2
  (mmdet/ops/dcn/deform_pool.py): RoIAlign bins moved by learned offsets,
  scaled by ``gamma`` times the box's size, with an optional modulation.
  Its samples take ``ops/roi.py``'s route: one (B, R, n * n, 2) position
  tensor an image, kernel K6 forward and K3 backward (or their plain
  versions); the offsets get their gradient through the positions.
"""
from __future__ import annotations

import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import same_pad
from kgdet_tpu_torch.ops.deform_kernels import deform_sample_hybrid
from kgdet_tpu_torch.ops.roi import _bin_mean, roi_positions


def masked_conv2d(x, mask, weight, bias=None, stride=1):
    """Conv evaluated only where mask > 0 (zeros elsewhere), 'SAME'
    padding. x (B, H, W, C); mask (B, H', W') on the output grid; weight
    (k, k, C, Cout), the JAX layout. Returns (B, H', W', Cout)."""
    k = weight.shape[0]
    if weight.shape[1] != k:
        raise ValueError(f'masked_conv2d takes square kernels, got '
                         f'{tuple(weight.shape[:2])}')
    y = F.conv2d(same_pad(x.permute(0, 3, 1, 2), k, stride),
                 weight.permute(3, 2, 0, 1).to(x.dtype), stride=stride)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y * (mask[..., None] > 0).to(y.dtype)


def deform_roi_pooling(feat, boxes, offsets, out_size=7, spatial_scale=1.0,
                       sample_num=2, gamma=0.1, modulation=None):
    """Deformable RoI pooling of a (B, H, W, C) map over per-image boxes
    (B, R, 4): each bin's samples moved by offsets (B, R, out, out, 2), the
    normalized (dy, dx) of the bin, times gamma times the box's height /
    width; modulation (B, R, out, out) gates the bins where given. Returns
    (B, R, out, out, C)."""
    pos = roi_positions(boxes, out_size, spatial_scale, sample_num,
                        offsets=offsets, gamma=gamma)
    out = _bin_mean(deform_sample_hybrid(feat, pos), out_size, sample_num)
    if modulation is not None:
        out = out * modulation[..., None].to(out.dtype)
    return out
