"""SSDVGG backbone: VGG-16/19 trunk + SSD extra layers + L2Norm.

Port of kgdet_tpu/models/vgg.py: the mmcv VGG features with ceil-mode 2x2
pools, the stride-1 3x3 pool5 with the dilated fc6 and the 1x1 fc7, the
extra layers alternating 1x1 / 3x3 ('S' a stride-2 3x3), and the
per-channel L2Norm on the conv4_3 output. ``features`` is the reference's
nn.Sequential, its convs, ReLUs and pools at the reference indices, so the
state_dict keys are the reference's (backbone.features.<i>.*,
backbone.extra.<i>.*, backbone.l2_norm.weight). Every conv runs in the
input's dtype on f32 weights; activations are NCHW. Returns the SSD300
(6-level) or SSD512 (7-level) pyramid.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import init_normal_

VGG_ARCH = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}

# SSD extra-layer output-channel programs ('S' marks a stride-2 3x3)
EXTRA_SETTING = {
    300: (256, 'S', 512, 128, 'S', 256, 128, 256, 128, 256),
    512: (256, 'S', 512, 128, 'S', 256, 128, 'S', 256, 128, 'S', 256, 128),
}


def vgg_out_channels(input_size: int):
    """The channels of each level SSDVGG returns: conv4_3, fc7, then the
    second conv of each extra pair (and SSD512's last 4x4 conv)."""
    extra = [c for c in EXTRA_SETTING[input_size] if c != 'S']
    return (512, 1024, *extra[1::2]) + ((256,) if input_size == 512 else ())


class L2Norm(nn.Module):
    """Per-channel L2 normalization with a learned scale (init
    ``scale_init``): the norm over channels in f32, the result in the
    input's dtype."""

    def __init__(self, channels: int, scale_init: float = 20.0,
                 eps: float = 1e-10):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.full((channels,), scale_init))

    def forward(self, x):
        xf = x.float()
        norm = xf.square().sum(dim=1, keepdim=True).sqrt() + self.eps
        return (self.weight[:, None, None] * xf / norm).to(x.dtype)


class SSDVGG(nn.Module):
    """VGG trunk + SSD extras; returns the 6-level (300) / 7-level (512)
    feature pyramid, conv4_3 L2-normalized."""

    def __init__(self, depth: int = 16, input_size: int = 300,
                 with_last_pool: bool = False,
                 out_feature_indices=(22, 34), l2_norm_scale: float = 20.0):
        super().__init__()
        if depth not in VGG_ARCH:
            raise ValueError(
                f'SSDVGG depth must be one of {sorted(VGG_ARCH)}, got '
                f'{depth!r} (set backbone.depth explicitly; the '
                f'BackboneConfig default of 50 is a ResNet depth)')
        if input_size not in EXTRA_SETTING:
            raise ValueError(f'SSDVGG input_size must be one of '
                             f'{sorted(EXTRA_SETTING)}, got {input_size!r}')
        self.input_size = input_size
        self.out_feature_indices = tuple(out_feature_indices)
        layers, cin = [], 3
        arch = VGG_ARCH[depth]
        for block, n_convs in enumerate(arch):
            width = (64, 128, 256, 512, 512)[block]
            for _ in range(n_convs):
                layers += [nn.Conv2d(cin, width, 3, padding=1),
                           nn.ReLU()]
                cin = width
            if block < len(arch) - 1 or with_last_pool:
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
        layers += [nn.MaxPool2d(3, 1, 1),
                   nn.Conv2d(cin, 1024, 3, padding=6, dilation=6),
                   nn.ReLU(), nn.Conv2d(1024, 1024, 1),
                   nn.ReLU()]
        self.features = nn.Sequential(*layers)

        extra, cin, n, i = [], 1024, 0, 0
        setting = EXTRA_SETTING[input_size]
        while i < len(setting):
            if setting[i] == 'S':
                extra.append(nn.Conv2d(cin, setting[i + 1], 3, 2, 1))
                cin, i = setting[i + 1], i + 2
            else:
                k = (1, 3)[n % 2]
                extra.append(nn.Conv2d(cin, setting[i], k))
                cin, i = setting[i], i + 1
            n += 1
        if input_size == 512:
            extra.append(nn.Conv2d(cin, 256, 4, padding=1))
        self.extra = nn.ModuleList(extra)
        self.l2_norm = L2Norm(
            self.features[self.out_feature_indices[0] - 1].out_channels,
            l2_norm_scale)

    @classmethod
    def from_config(cls, bcfg):
        return cls(depth=bcfg.depth, input_size=bcfg.vgg_input_size,
                   with_last_pool=bcfg.vgg_with_last_pool,
                   l2_norm_scale=bcfg.l2_norm_scale)

    def init_weights(self, gen: torch.Generator):
        """He-normal (fan-in) conv weights, zero biases; the L2Norm scale
        keeps its init."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                init_normal_(m.weight, math.sqrt(2.0 / fan_in), gen)
                nn.init.zeros_(m.bias)

    def forward(self, x):
        """x: (B, H, W, 3) NHWC in the compute dtype. Returns the pyramid
        levels as NCHW tensors."""
        x = x.permute(0, 3, 1, 2)
        outs = []
        for i, layer in enumerate(self.features):
            x = _conv(x, layer) if isinstance(layer, nn.Conv2d) \
                else layer(x)
            if i in self.out_feature_indices:
                outs.append(x)
        for n, conv in enumerate(self.extra):
            x = torch.relu(_conv(x, conv))
            if n % 2 == 1:
                outs.append(x)
        outs[0] = self.l2_norm(outs[0])
        return tuple(outs)


def _conv(x, conv):
    dt = x.dtype
    return F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), conv.stride,
                    conv.padding, conv.dilation)
