"""Shared building blocks: FrozenBatchNorm, ConvModule, ConvWS and seeded
inits.

Port of kgdet_tpu/models/layers.py. Parameters are stored in f32 under the
reference's torch names; each module casts its weights to the activation
dtype at call time (bf16 compute, f32 master weights, as in the JAX
reference). Activations are NCHW.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen running statistics (norm_eval=True): f32
    affine, result stored in the input dtype. ``num_batches_tracked`` is
    kept so reference checkpoints load with strict=True."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer('running_mean', torch.zeros(channels))
        self.register_buffer('running_var', torch.ones(channels))
        self.register_buffer('num_batches_tracked',
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean[:, None, None]) \
            * inv[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def same_pad(x, k: int, stride: int):
    """Zero-pad NCHW x like flax 'SAME': out = ceil(in / stride), with the
    odd pixel of padding at the end (asymmetric at stride 2)."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class ConvModule(nn.Module):
    """conv -> (GroupNorm ``gn`` | FrozenBatchNorm ``bn``) -> (ReLU); bias
    off whenever ``norm`` is set (any other name, as in the JAX module,
    adds no norm layer). 'SAME' padding. GN statistics are taken in f32."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, norm=None,
                 gn_groups: int = 32, act: bool = True):
        super().__init__()
        self.stride = stride
        self.k = kernel_size
        self.act = act
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride, bias=norm is None)
        self.gn = nn.GroupNorm(gn_groups, out_channels, eps=1e-5) \
            if norm == 'gn' else None
        self.bn = FrozenBatchNorm(out_channels) \
            if norm == 'frozen_bn' else None

    def forward(self, x):
        dt = x.dtype
        w = self.conv.weight.to(dt)
        b = None if self.conv.bias is None else self.conv.bias.to(dt)
        if self.stride == 1 and self.k % 2:
            y = F.conv2d(x, w, b, padding=self.k // 2)
        else:
            y = F.conv2d(same_pad(x, self.k, self.stride), w, b,
                         stride=self.stride)
        if self.gn is not None:
            y = F.group_norm(y.float(), self.gn.num_groups, self.gn.weight,
                             self.gn.bias, self.gn.eps).to(dt)
        elif self.bn is not None:
            y = self.bn(y)
        return torch.relu(y) if self.act else y


class ConvWS(nn.Module):
    """Weight-standardized conv (the reference's conv_ws.py): the weight is
    normalized to zero mean and unit (population) std over (Cin, kh, kw)
    per output channel, in f32, before the convolution. ``padding`` 'SAME'
    as flax pads, or an int on every side."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding='SAME',
                 bias: bool = True, eps: float = 1e-5):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias \
            else None
        nn.init.kaiming_normal_(self.weight, mode='fan_out')

    def forward(self, x):
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        std = w.std(dim=(1, 2, 3), keepdim=True, unbiased=False)
        w = ((w - mean) / (std + self.eps)).to(x.dtype)
        k = w.shape[-1]
        if self.padding == 'SAME':
            x, pad = same_pad(x, k, self.stride), 0
        else:
            pad = self.padding
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, stride=self.stride, padding=pad)


def head_out(x, conv):
    """An output conv (3x3 padded or 1x1) with its bias, in x's dtype
    (NCHW), as the (1, B, H, W, C) NHWC map of the single-stage heads'
    output layout."""
    dt = x.dtype
    y = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                 padding=conv.padding)
    return y.permute(0, 2, 3, 1)[None]


# ------------------------------------------------------------ seeded inits
# Same distributions as the JAX inits (layers.py he_normal_init,
# normal_init, fpn.xavier_uniform_init); values differ, as the generators
# do. Samples are drawn on the CPU from a torch.Generator, then copied.
def init_normal_(t, std: float, gen: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def init_he_normal_(w, gen: torch.Generator):
    """Variance-scaling 2.0 over fan_out (kh * kw * Cout)."""
    fan_out = w.shape[0] * w[0, 0].numel()
    init_normal_(w, math.sqrt(2.0 / fan_out), gen)


def init_xavier_uniform_(w, gen: torch.Generator):
    rf = w[0, 0].numel()
    bound = math.sqrt(6.0 / (w.shape[0] * rf + w.shape[1] * rf))
    with torch.no_grad():
        w.copy_((torch.rand(w.shape, generator=gen) * 2 - 1) * bound)


def init_variance_scaling_(w, gen: torch.Generator, scale: float = 1.0,
                           distribution: str = 'truncated_normal'):
    """flax's ``variance_scaling`` on a torch-layout weight ((out, in, ...)
    conv or linear) over its fan-in: the default ``lecun_normal`` (scale 1,
    truncated at two standard deviations), or ``uniform``."""
    fan_in = w.shape[1] * (w[0, 0].numel() if w.dim() > 2 else 1)
    var = scale / max(fan_in, 1)
    with torch.no_grad():
        if distribution == 'uniform':
            lim = math.sqrt(3 * var)
            w.copy_((torch.rand(w.shape, generator=gen) * 2 - 1) * lim)
        else:
            std = math.sqrt(var) / .87962566103423978
            w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), std=std,
                                          a=-2 * std, b=2 * std,
                                          generator=gen))


def bias_prior(prior_prob: float = 0.01) -> float:
    """Focal-loss classification bias prior."""
    return float(-math.log((1 - prior_prob) / prior_prob))

