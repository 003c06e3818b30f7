"""SSD multibox head: one 3x3 conv pair a level, softmax classification.

Port of kgdet_tpu/models/ssd_head.py: per level ``cls_convs.<i>`` emits
A_i * (num_classes + 1) logits (softmax, background at 0) and
``reg_convs.<i>`` A_i * 4 deltas, A_i = 2 + 2 * len(ratios_i) SSD anchors
(min/max sizes stepped over basesize_ratio_range; ratio-1 anchors at two
scales, then (1/r, r) pairs). Runs on any pyramid: the VGG trunk's levels
with the ``Identity`` neck, or a neck's. The MultiBox loss is
core/anchor_loss.py::ssd_loss. Outputs keep the JAX layout: per level
cls (1, B, H, W, A*(C+1)) and bbox (1, B, H, W, A*4).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from kgdet_tpu_torch.models.layers import head_out, init_xavier_uniform_
from kgdet_tpu_torch.ops.anchors import ssd_anchor_params, ssd_base_anchors


def ssd_base_anchor_set(input_size, strides, basesize_ratio_range, ratios):
    """Per level the (A_i, 4) SSD base anchors."""
    mins, maxs = ssd_anchor_params(input_size, len(strides),
                                   basesize_ratio_range)
    return [ssd_base_anchors(mins[i], maxs[i], strides[i], ratios[i])
            for i in range(len(strides))]


class SSDHead(nn.Module):
    def __init__(self, num_classes: int = 13,
                 in_channels: Sequence[int] = (256,) * 5,
                 anchor_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 input_size: int = 300,
                 basesize_ratio_range: Tuple[float, float] = (0.15, 0.9),
                 anchor_ratios=((2,), (2, 3), (2, 3), (2, 3), (2,))):
        super().__init__()
        self.num_classes = num_classes
        self.anchor_strides = tuple(anchor_strides)
        self.input_size = input_size
        self.basesize_ratio_range = tuple(basesize_ratio_range)
        self.anchor_ratios = tuple(tuple(r) for r in anchor_ratios)
        if len(in_channels) != len(self.anchor_strides):
            raise ValueError(f'{len(in_channels)} input levels for '
                             f'{len(self.anchor_strides)} anchor strides')
        nA, C1 = self.num_anchors_per_level(), num_classes + 1
        self.cls_convs = nn.ModuleList(
            nn.Conv2d(c, a * C1, 3, padding=1)
            for c, a in zip(in_channels, nA))
        self.reg_convs = nn.ModuleList(
            nn.Conv2d(c, a * 4, 3, padding=1)
            for c, a in zip(in_channels, nA))

    @classmethod
    def from_config(cls, cfg, in_channels):
        h = cfg.head
        return cls(num_classes=h.num_classes, in_channels=in_channels,
                   anchor_strides=h.point_strides,
                   input_size=h.ssd_input_size,
                   basesize_ratio_range=h.ssd_basesize_ratio_range,
                   anchor_ratios=h.ssd_anchor_ratios)

    def num_anchors_per_level(self):
        return [2 + 2 * len(r) for r in self.anchor_ratios]

    def base_anchors_per_level(self):
        return ssd_base_anchor_set(self.input_size, self.anchor_strides,
                                   self.basesize_ratio_range,
                                   self.anchor_ratios)

    def init_weights(self, gen: torch.Generator):
        """Xavier-uniform weights, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_xavier_uniform_(m.weight, gen)
                nn.init.zeros_(m.bias)

    def forward(self, feats):
        assert len(feats) == len(self.anchor_strides)
        outs = []
        for x, cls_conv, reg_conv in zip(feats, self.cls_convs,
                                         self.reg_convs):
            outs.append({'cls': head_out(x, cls_conv),
                         'bbox': head_out(x, reg_conv)})
        return outs
