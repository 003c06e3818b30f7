"""Guided-anchoring heads (GA-Retina, GA-RPN).

Port of kgdet_tpu/models/ga_head.py: RetinaNet towers, then a 1x1
``conv_loc`` (anchor location logit, its bias at the focal-loss prior) off
the cls tower and a 1x1 ``conv_shape`` (the anchor's (dw, dh)) off the reg
tower; each tower is realigned by a ``FeatureAdaption`` before the 3x3
``retina_cls`` / ``retina_reg``. Names follow the reference
(ga_retina_head.py: cls_convs.<i>, reg_convs.<i>, conv_loc, conv_shape,
feature_adaption_cls / _reg.conv_offset / .conv_adaption, retina_cls,
retina_reg).

``FeatureAdaption`` is a 3x3 deformable conv (``DeformConv3x3``, DCN v1)
whose offsets a bias-free 1x1 conv makes from the detached shape
prediction. It samples through ops/deform.py::deform_conv: kernel K6
forward and K3 backward on the card.

Where the JAX package departs from the published recipe, the port follows
the JAX package: one deformable group (18 offset channels; the reference
has 4, 72 channels, so a reference checkpoint's ``conv_offset`` does not
load), and the reference's masked convs evaluated densely.

``GARPNHead`` (ga_rpn_head.py) is the two-stage detectors' guided-anchor
RPN: a shared 3x3 ``rpn_conv``, ``conv_loc`` and ``conv_shape`` off it,
one ``feature_adaption``, then the 1x1 class-agnostic ``conv_cls`` /
``conv_reg``.

Output per level, in the JAX layout: cls (1, B, H, W, num_classes), bbox
(1, B, H, W, 4) deltas on the guided anchor, shape (1, B, H, W, 2), loc
(1, B, H, W, 1).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import ConvModule, bias_prior, \
    head_out, init_normal_
from kgdet_tpu_torch.models.resnet import DeformConv3x3


class FeatureAdaption(nn.Module):
    """relu(3x3 deformable conv of x) with offsets conv_offset(detached
    shape prediction): x (B, C, H, W), shape_pred (B, 2, H, W) ->
    (B, F, H, W)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv_offset = nn.Conv2d(2, 18, 1, bias=False)
        self.conv_adaption = DeformConv3x3(in_channels, out_channels)

    def forward(self, x, shape_pred):
        offs = F.conv2d(shape_pred.detach(),
                        self.conv_offset.weight.to(shape_pred.dtype))
        return torch.relu(self.conv_adaption(x, offs))


class GARetinaHead(nn.Module):
    def __init__(self, num_classes: int = 13, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 anchor_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 norm: Optional[str] = None, gn_groups: int = 32):
        super().__init__()
        self.anchor_strides = tuple(anchor_strides)
        for prefix in ('cls', 'reg'):
            setattr(self, f'{prefix}_convs', nn.ModuleList(
                ConvModule(in_channels if i == 0 else feat_channels,
                           feat_channels, 3, norm=norm, gn_groups=gn_groups)
                for i in range(stacked_convs)))
        self.conv_loc = nn.Conv2d(feat_channels, 1, 1)
        self.conv_shape = nn.Conv2d(feat_channels, 2, 1)
        self.feature_adaption_cls = FeatureAdaption(feat_channels,
                                                    feat_channels)
        self.feature_adaption_reg = FeatureAdaption(feat_channels,
                                                    feat_channels)
        self.retina_cls = nn.Conv2d(feat_channels, num_classes, 3, padding=1)
        self.retina_reg = nn.Conv2d(feat_channels, 4, 3, padding=1)

    @classmethod
    def from_config(cls, cfg):
        h = cfg.head
        return cls(num_classes=h.num_classes,
                   in_channels=cfg.neck.out_channels,
                   feat_channels=h.feat_channels,
                   stacked_convs=h.stacked_convs,
                   anchor_strides=h.point_strides, norm=h.norm,
                   gn_groups=h.gn_groups)

    def init_weights(self, gen):
        """N(0, 0.01) weights and zero biases, N(0, 0.1) offset convs, the
        loc and cls biases at the focal-loss prior (p = 0.01)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, DeformConv3x3)):
                init_normal_(m.weight, 0.01, gen)
                if getattr(m, 'bias', None) is not None:
                    nn.init.zeros_(m.bias)
        for fa in (self.feature_adaption_cls, self.feature_adaption_reg):
            init_normal_(fa.conv_offset.weight, 0.1, gen)
        for conv in (self.conv_loc, self.retina_cls):
            nn.init.constant_(conv.bias, bias_prior(0.01))

    def forward(self, feats):
        assert len(feats) == len(self.anchor_strides)
        outs = []
        for x in feats:
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            loc = head_out(cls_feat, self.conv_loc)
            shape = head_out(reg_feat, self.conv_shape)
            shape_nchw = shape[0].permute(0, 3, 1, 2)
            cls_feat = self.feature_adaption_cls(cls_feat, shape_nchw)
            reg_feat = self.feature_adaption_reg(reg_feat, shape_nchw)
            outs.append({'cls': head_out(cls_feat, self.retina_cls),
                         'bbox': head_out(reg_feat, self.retina_reg),
                         'shape': shape, 'loc': loc})
        return outs


class GARPNHead(nn.Module):
    """Guided-anchor RPN: per level cls (1, B, H, W, 1) objectness, bbox
    (1, B, H, W, 4) deltas on the guided anchor, shape and loc."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.conv_loc = nn.Conv2d(feat_channels, 1, 1)
        self.conv_shape = nn.Conv2d(feat_channels, 2, 1)
        self.feature_adaption = FeatureAdaption(feat_channels, feat_channels)
        self.conv_cls = nn.Conv2d(feat_channels, 1, 1)
        self.conv_reg = nn.Conv2d(feat_channels, 4, 1)

    def init_weights(self, gen):
        """N(0, 0.01) weights and zero biases, an N(0, 0.1) offset conv,
        the loc bias at the focal-loss prior (p = 0.01)."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, DeformConv3x3)):
                init_normal_(m.weight, 0.01, gen)
                if getattr(m, 'bias', None) is not None:
                    nn.init.zeros_(m.bias)
        init_normal_(self.feature_adaption.conv_offset.weight, 0.1, gen)
        nn.init.constant_(self.conv_loc.bias, bias_prior(0.01))

    def forward(self, feats):
        outs = []
        for x in feats:
            dt = x.dtype
            t = torch.relu(F.conv2d(x, self.rpn_conv.weight.to(dt),
                                    self.rpn_conv.bias.to(dt), padding=1))
            loc = head_out(t, self.conv_loc)
            shape = head_out(t, self.conv_shape)
            t_a = self.feature_adaption(t, shape[0].permute(0, 3, 1, 2))
            outs.append({'cls': head_out(t_a, self.conv_cls),
                         'bbox': head_out(t_a, self.conv_reg),
                         'shape': shape, 'loc': loc})
        return outs
