"""FCOS head: anchor-free per-pixel classification + distance regression.

Port of kgdet_tpu/models/fcos_head.py: ``stacked_convs`` 3x3 tower convs a
branch (GN by default), sigmoid ``fcos_cls`` (its bias at the focal-loss
prior), ``fcos_centerness`` off the cls tower, and (l, t, r, b) distances
exp(``fcos_reg`` * the level's learnable scale), taken in f32 in both
compute dtypes. Names follow the reference (cls_convs.<i>, reg_convs.<i>,
fcos_cls, fcos_reg, fcos_centerness, scales.<level>.scale: one scalar a
level, where the JAX module holds one ``scales`` vector).

Output per level, in the JAX layout: cls (1, B, H, W, C), bbox
(1, B, H, W, 4) distances in pixels (f32), centerness (1, B, H, W, 1).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from kgdet_tpu_torch.models.layers import ConvModule, bias_prior, \
    head_out, init_normal_


class Scale(nn.Module):
    """One learnable scalar (the reference's mmdet ``Scale``)."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(scale, dtype=torch.float32))


class FCOSHead(nn.Module):
    def __init__(self, num_classes: int = 13, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 norm: Optional[str] = 'gn', gn_groups: int = 32):
        super().__init__()
        self.strides = tuple(strides)
        for prefix in ('cls', 'reg'):
            setattr(self, f'{prefix}_convs', nn.ModuleList(
                ConvModule(in_channels if i == 0 else feat_channels,
                           feat_channels, 3, norm=norm, gn_groups=gn_groups)
                for i in range(stacked_convs)))
        self.fcos_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.fcos_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)
        self.fcos_centerness = nn.Conv2d(feat_channels, 1, 3, padding=1)
        self.scales = nn.ModuleList(Scale() for _ in self.strides)

    @classmethod
    def from_config(cls, cfg):
        h = cfg.head
        return cls(num_classes=h.num_classes, in_channels=h.in_channels,
                   feat_channels=h.feat_channels,
                   stacked_convs=h.stacked_convs, strides=h.point_strides,
                   norm=h.norm, gn_groups=h.gn_groups)

    def init_weights(self, gen):
        """N(0, 0.01) conv weights, zero biases, the cls bias at the
        focal-loss prior (p = 0.01), every scale 1."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_normal_(m.weight, 0.01, gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        nn.init.constant_(self.fcos_cls.bias, bias_prior(0.01))
        for s in self.scales:
            nn.init.ones_(s.scale)

    def forward(self, feats):
        assert len(feats) == len(self.strides)
        outs = []
        for x, scale in zip(feats, self.scales):
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            dist = torch.exp(head_out(reg_feat, self.fcos_reg).float()
                             * scale.scale)
            outs.append({
                'cls': head_out(cls_feat, self.fcos_cls),
                'bbox': dist,
                # off the cls tower, as the reference (fcos_head.py:107)
                'centerness': head_out(cls_feat, self.fcos_centerness)})
        return outs
