"""Extra necks: HRFPN (the HRNet pyramid), BFP (Libra R-CNN) and FPNBFP
(an FPN, then a BFP refine).

Port of kgdet_tpu/models/necks_extra.py on NCHW maps, under the
reference's names (necks/hrfpn.py: reduction_conv.conv, fpn_convs.<i>.conv;
necks/bfp.py: refine, a ConvModule or a NonLocal2D; the Libra neck list:
neck.0 the FPN, neck.1 the BFP). The JAX module's resizes keep their
meaning: ``jax.image.resize`` samples at half-pixel centres, so its
'nearest' is ``F.interpolate(mode='nearest-exact')`` and its 'bilinear' is
``mode='bilinear', align_corners=False``; flax's pools are VALID (no
padding, floor).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.fpn import FPN
from kgdet_tpu_torch.models.layers import ConvModule, \
    init_variance_scaling_
from kgdet_tpu_torch.models.plugins import NonLocal2D


def _resize(x, hw, mode):
    if tuple(x.shape[2:]) == tuple(hw):
        return x
    if mode == 'nearest':
        return F.interpolate(x, size=tuple(hw), mode='nearest-exact')
    return F.interpolate(x, size=tuple(hw), mode='bilinear',
                         align_corners=False)


class HRFPN(nn.Module):
    """Every branch upsampled (bilinear) to the finest, concatenated,
    reduced by a 1x1 conv, pooled into ``num_outs`` levels (avg or max, k
    = 2^i), a 3x3 conv a level."""

    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 256, num_outs: int = 5,
                 pooling: str = 'avg'):
        super().__init__()
        self.in_channels = tuple(in_channels)
        self.pooling = pooling
        self.reduction_conv = ConvModule(sum(in_channels), out_channels, 1,
                                         act=False)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, act=False)
            for _ in range(num_outs))

    @classmethod
    def from_config(cls, ncfg):
        return cls(in_channels=ncfg.in_channels,
                   out_channels=ncfg.out_channels, num_outs=ncfg.num_outs)

    def init_weights(self, gen):
        """Kaiming-uniform weights (variance scaling 2, fan in), zero
        biases, as the JAX module."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_variance_scaling_(m.weight, gen, 2.0,
                                       distribution='uniform')
                nn.init.zeros_(m.bias)

    def forward(self, inputs):
        assert len(inputs) == len(self.in_channels)
        hw = inputs[0].shape[2:]
        x = torch.cat([inputs[0]] + [_resize(f, hw, 'bilinear')
                                     for f in inputs[1:]], dim=1)
        x = self.reduction_conv(x)
        pool = F.avg_pool2d if self.pooling == 'avg' else F.max_pool2d
        outs = [x] + [pool(x, 2 ** i, 2 ** i)
                      for i in range(1, len(self.fpn_convs))]
        return tuple(conv(o) for conv, o in zip(self.fpn_convs, outs))


class BFP(nn.Module):
    """Balanced feature pyramid: the levels gathered to the refine level's
    size (max pool down, nearest resize up), averaged, refined (a 3x3 conv
    or a non-local block, or nothing), and scattered back as a residual to
    every level."""

    def __init__(self, out_channels: int = 256, num_levels: int = 5,
                 refine_level: int = 2, refine_type='non_local'):
        super().__init__()
        self.num_levels = num_levels
        self.refine_level = refine_level
        self.refine_type = refine_type
        if refine_type == 'conv':
            self.refine = ConvModule(out_channels, out_channels, 3,
                                     act=False)
        elif refine_type == 'non_local':
            self.refine = NonLocal2D(out_channels)

    @classmethod
    def from_config(cls, ncfg):
        return cls(out_channels=ncfg.out_channels, num_levels=ncfg.num_outs,
                   refine_level=ncfg.bfp_refine_level,
                   refine_type=ncfg.bfp_refine_type)

    def init_weights(self, gen):
        if self.refine_type == 'conv':
            init_variance_scaling_(self.refine.conv.weight, gen)
            nn.init.zeros_(self.refine.conv.bias)
        elif self.refine_type == 'non_local':
            self.refine.init_weights(gen)

    def forward(self, inputs):
        assert len(inputs) == self.num_levels
        ref_hw = inputs[self.refine_level].shape[2:]
        gathered = []
        for i, f in enumerate(inputs):
            if i < self.refine_level:
                k = f.shape[2] // ref_hw[0]
                f = F.max_pool2d(f, k, k) if k > 1 else f
            gathered.append(_resize(f, ref_hw, 'nearest'))
        bsf = sum(gathered) / len(gathered)
        if self.refine_type in ('conv', 'non_local'):
            bsf = self.refine(bsf)
        outs = []
        for i, f in enumerate(inputs):
            hw = f.shape[2:]
            r = bsf
            if i >= self.refine_level:
                k = bsf.shape[2] // max(hw[0], 1)
                r = F.max_pool2d(bsf, k, k) if k > 1 else bsf
            outs.append(f + _resize(r, hw, 'nearest'))
        return tuple(outs)


class FPNBFP(nn.Module):
    """FPN (every level), then BFP over its levels; ``select_out`` picks
    levels after the refine. Children '0' and '1', as the reference's neck
    list."""

    def __init__(self, in_channels=(256, 512, 1024, 2048),
                 out_channels: int = 256, start_level: int = 0,
                 end_level: int = -1, num_outs: int = 5,
                 add_extra_convs: bool = False, select_out=None, norm=None,
                 gn_groups: int = 32, refine_level: int = 2,
                 refine_type='non_local'):
        super().__init__()
        self.select_out = None if select_out is None else tuple(select_out)
        self.add_module('0', FPN(
            in_channels, out_channels, num_outs, start_level, end_level,
            add_extra_convs, select_out=None, norm=norm,
            gn_groups=gn_groups))
        self.add_module('1', BFP(out_channels, num_outs, refine_level,
                                 refine_type))

    @classmethod
    def from_config(cls, ncfg):
        return cls(in_channels=ncfg.in_channels,
                   out_channels=ncfg.out_channels,
                   start_level=ncfg.start_level, end_level=ncfg.end_level,
                   num_outs=ncfg.num_outs,
                   add_extra_convs=ncfg.add_extra_convs,
                   select_out=ncfg.select_out, norm=ncfg.norm,
                   gn_groups=ncfg.gn_groups,
                   refine_level=ncfg.bfp_refine_level,
                   refine_type=ncfg.bfp_refine_type)

    def init_weights(self, gen):
        for child in self.children():
            child.init_weights(gen)

    def forward(self, inputs):
        outs = getattr(self, '1')(getattr(self, '0')(inputs))
        if self.select_out is not None:
            return tuple(outs[i] for i in self.select_out)
        return outs
