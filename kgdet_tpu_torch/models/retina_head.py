"""RetinaNet head: anchor-based single-stage classification + box regression.

Port of kgdet_tpu/models/retina_head.py: ``stacked_convs`` 3x3 tower convs
a branch (plain with a bias, or GN), ``retina_cls`` with A * num_classes
sigmoid logits (its bias at the focal-loss prior) and ``retina_reg`` with
A * 4 deltas a location, over every pyramid level with octave anchor
scales. Names follow the reference (cls_convs.<i>, reg_convs.<i>,
retina_cls, retina_reg). Outputs keep the JAX layout: per level a dict with
cls (1, B, H, W, A*num_classes) and bbox (1, B, H, W, A*4), delta-encoded
(decoded in core/anchor_loss.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.nn as nn

from kgdet_tpu_torch.models.layers import ConvModule, bias_prior, \
    head_out, init_normal_
from kgdet_tpu_torch.ops.anchors import base_anchors


def retina_base_anchors(octave_base_scale, scales_per_octave, ratios,
                        strides):
    """Per level the (A, 4) base anchors of the octave recipe: scales
    octave_base_scale * 2^(i / scales_per_octave) of the level's stride."""
    scales = [octave_base_scale * 2 ** (i / scales_per_octave)
              for i in range(scales_per_octave)]
    return [base_anchors(s, scales, ratios) for s in strides]


class RetinaHead(nn.Module):
    def __init__(self, num_classes: int = 13, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 octave_base_scale: int = 4, scales_per_octave: int = 3,
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 norm: Optional[str] = None, gn_groups: int = 32):
        super().__init__()
        self.num_classes = num_classes
        self.octave_base_scale = octave_base_scale
        self.scales_per_octave = scales_per_octave
        self.anchor_ratios = tuple(anchor_ratios)
        self.anchor_strides = tuple(anchor_strides)
        A = self.num_anchors
        for prefix in ('cls', 'reg'):
            setattr(self, f'{prefix}_convs', nn.ModuleList(
                ConvModule(in_channels if i == 0 else feat_channels,
                           feat_channels, 3, norm=norm, gn_groups=gn_groups)
                for i in range(stacked_convs)))
        self.retina_cls = nn.Conv2d(feat_channels, A * num_classes, 3,
                                    padding=1)
        self.retina_reg = nn.Conv2d(feat_channels, A * 4, 3, padding=1)

    @classmethod
    def from_config(cls, cfg):
        h = cfg.head
        return cls(num_classes=h.num_classes, in_channels=h.in_channels,
                   feat_channels=h.feat_channels,
                   stacked_convs=h.stacked_convs,
                   octave_base_scale=h.octave_base_scale,
                   scales_per_octave=h.scales_per_octave,
                   anchor_ratios=h.anchor_ratios,
                   anchor_strides=h.point_strides, norm=h.norm,
                   gn_groups=h.gn_groups)

    @property
    def num_anchors(self):
        return len(self.anchor_ratios) * self.scales_per_octave

    def base_anchors_per_level(self):
        return retina_base_anchors(self.octave_base_scale,
                                   self.scales_per_octave,
                                   self.anchor_ratios, self.anchor_strides)

    def init_weights(self, gen):
        """N(0, 0.01) weights and zero biases everywhere, the cls bias at
        the focal-loss prior (p = 0.01)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_normal_(m.weight, 0.01, gen)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
        nn.init.constant_(self.retina_cls.bias, bias_prior(0.01))

    def forward(self, feats):
        assert len(feats) == len(self.anchor_strides)
        outs = []
        for x in feats:
            cls_feat, reg_feat = x, x
            for conv in self.cls_convs:
                cls_feat = conv(cls_feat)
            for conv in self.reg_convs:
                reg_feat = conv(reg_feat)
            outs.append({'cls': head_out(cls_feat, self.retina_cls),
                         'bbox': head_out(reg_feat, self.retina_reg)})
        return outs

