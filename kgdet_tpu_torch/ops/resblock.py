"""Frozen ResNet bottleneck math with FrozenBatchNorm folded into the convs.

Port of kgdet_tpu/ops/pallas_resblock.py::fold_bn and
::bottleneck_reference. ``bottleneck_reference`` is also the plain version
of kernel K5 (ops/stem_kernels.py::frozen_bottleneck).

Weight convention (as in the JAX reference): w1 (Cin, width), w2
(3, 3, width, width) HWIO, w3 (width, Cout), wd (Cin, Cout) or None; f32
biases. Activations are NHWC (B, H, W, C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fold_bn(kernel, scale, bias, mean, var, eps=1e-5):
    """Fold a FrozenBatchNorm that FOLLOWS a conv into the conv:
    bn(conv(x, K)) == conv(x, K * inv) + (bias - mean * inv) with
    inv = scale / sqrt(var + eps). kernel: (..., Cout). Returns f32
    (folded_kernel, folded_bias)."""
    inv = (scale * torch.rsqrt(var + eps)).float()
    return kernel.float() * inv, bias - mean * inv


def _conv(x, w_oihw, padding=0):
    """NHWC in, NHWC-shaped (channels_last) out, in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw.to(x.dtype), padding=padding)
    return y.permute(0, 2, 3, 1)


def bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """relu(conv1x1 -> relu -> conv3x3 -> relu -> conv1x1 + identity or
    downsample) with folded weights; intermediates rounded to x's dtype."""
    dt = x.dtype
    a = torch.relu(_conv(x, w1.t()[:, :, None, None]).float() + b1).to(dt)
    b_ = torch.relu(_conv(a, w2.permute(3, 2, 0, 1), padding=1).float()
                    + b2).to(dt)
    c = _conv(b_, w3.t()[:, :, None, None]).float() + b3
    if wd is not None:
        ident = _conv(x, wd.t()[:, :, None, None]).float() + bd
    else:
        ident = x.float()
    return torch.relu(c + ident).to(dt)
