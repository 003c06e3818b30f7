"""Serial / parallel keypoint RepPoints heads and plain RepPoints (init +
refine over the 5-level FPN).

Port of kgdet_tpu/models/serial_head.py. Two-stage variants of the KGDet
idea:
- Serial: the init stage predicts the keypoints with a 3x3 conv; the 9-point
  RepPoints field is a 1x1 conv OF the keypoints; the refine stage samples
  the cls and pts features with one 3x3 deformable conv at the init
  RepPoints, outputs accumulating residually on the detached init stage.
- Parallel: the same, but the RepPoints fields (init and refine) come from
  their own conv branches instead of the keypoint field.
- ``with_keypoints=False``: plain RepPoints, no keypoint branch.

The refine stage runs ``deform_conv_fused`` once for the cls branch and once
for the pts branch with the kpt | rep weights concatenated on the output
axis: kernel K1 when no gradient is wanted (2 launches a level), and under
differentiation the column gather K6 forward and the sampling backward K3
(2 launches each a level).

Names follow the reference heads (cls_convs.<i>, reg_convs.<i>,
keypts_init_conv, keypts_init_out, reppts_init_conv, reppts_init_out,
{cls,keypts,reppts}_refine_dfmconv, {cls,keypts,reppts}_refine_out,
moment_transfer). Outputs keep the JAX layout: per level a dict of
stage-stacked tensors
  cls  (1, B, H, W, classes)        refine-stage logits
  kpt  (2, B, H, W, 2*keypoints)    init, refine (y-first offset pairs)
  bbox (2, B, H, W, 4)              decoded boxes per stage
  rep  (2, B, H, W, 2*reppoints)    raw RepPoints offset fields
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.kgdet_head import DeformConvWeight, dense_1x1
from kgdet_tpu_torch.models.layers import ConvModule, bias_prior, \
    init_normal_
from kgdet_tpu_torch.ops.deform import absolute_positions, grad_multiply
from kgdet_tpu_torch.ops.deform_kernels import deform_conv_fused
from kgdet_tpu_torch.ops.points import points2bbox


class SerialKpHead(nn.Module):
    """Init/refine keypoint head; ``parallel=True`` selects the Parallel
    variant, ``with_keypoints=False`` plain RepPoints."""

    def __init__(self, num_classes: int = 13, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_keypts: int = 294,
                 num_reppts: int = 9, gradient_mul: float = 0.1,
                 point_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 transform_method: str = 'moment', moment_mul: float = 0.01,
                 parallel: bool = False, with_keypoints: bool = True,
                 norm: Optional[str] = 'gn', gn_groups: int = 32):
        super().__init__()
        k = int(round(num_reppts ** 0.5))
        if k * k != num_reppts:
            raise ValueError(f'num_reppts {num_reppts} is not a square: the '
                             'refine deformable conv is k x k')
        self.num_keypts = num_keypts
        self.num_reppts = num_reppts
        self.gradient_mul = gradient_mul
        self.point_strides = tuple(point_strides)
        self.transform_method = transform_method
        self.moment_mul = moment_mul
        self.with_keypoints = with_keypoints
        self.own_rep_branch = parallel or not with_keypoints
        self._pts_weight = None     # (parts' layouts, their concat)
        for prefix in ('cls', 'reg'):
            setattr(self, f'{prefix}_convs', nn.ModuleList(
                ConvModule(in_channels if i == 0 else feat_channels,
                           feat_channels, 3, norm=norm, gn_groups=gn_groups)
                for i in range(stacked_convs)))
        C, Fp = feat_channels, point_feat_channels
        kpt_dim, rep_dim = 2 * num_keypts, 2 * num_reppts
        if with_keypoints:
            self.keypts_init_conv = nn.Conv2d(C, Fp, 3, padding=1)
            self.keypts_init_out = nn.Conv2d(Fp, kpt_dim, 1)
            self.keypts_refine_dfmconv = DeformConvWeight(C, Fp, k)
            self.keypts_refine_out = nn.Conv2d(Fp, kpt_dim, 1)
        if self.own_rep_branch:
            self.reppts_init_conv = nn.Conv2d(C, Fp, 3, padding=1)
            self.reppts_refine_dfmconv = DeformConvWeight(C, Fp, k)
        rep_in = Fp if self.own_rep_branch else kpt_dim
        self.reppts_init_out = nn.Conv2d(rep_in, rep_dim, 1)
        self.reppts_refine_out = nn.Conv2d(rep_in, rep_dim, 1)
        self.cls_refine_dfmconv = DeformConvWeight(C, Fp, k)
        self.cls_refine_out = nn.Conv2d(Fp, num_classes, 1)
        self.moment_transfer = nn.Parameter(torch.zeros(2)) \
            if transform_method == 'moment' else None

    @classmethod
    def from_config(cls, cfg, parallel=False, with_keypoints=True):
        h = cfg.head
        return cls(num_classes=h.num_classes, in_channels=h.in_channels,
                   feat_channels=h.feat_channels,
                   point_feat_channels=h.point_feat_channels,
                   stacked_convs=h.stacked_convs, num_keypts=h.num_keypts,
                   num_reppts=h.num_reppts, gradient_mul=h.gradient_mul,
                   point_strides=h.point_strides,
                   transform_method=h.transform_method,
                   moment_mul=h.moment_mul, parallel=parallel,
                   with_keypoints=with_keypoints, norm=h.norm,
                   gn_groups=h.gn_groups)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, DeformConvWeight)):
                init_normal_(m.weight, 0.01, gen)
                if getattr(m, 'bias', None) is not None:
                    nn.init.zeros_(m.bias)
        nn.init.constant_(self.cls_refine_out.bias, bias_prior(0.01))

    def to_bbox(self, reppts):
        return points2bbox(reppts.float(), self.transform_method,
                           self.moment_transfer, self.moment_mul)

    def pts_weight(self, parts, dtype):
        """The pts branches' tap-major weights side by side, (K, C, sum F).
        While the parts serve their kept layouts (the same tensors as at the
        last call), the concat is kept too."""
        ws = [m.tap_major(dtype) for m in parts]
        kept = self._pts_weight
        if kept is not None and len(kept[0]) == len(ws) \
                and all(a is b for a, b in zip(kept[0], ws)):
            return kept[1]
        w_cat = ws[0] if len(ws) == 1 else torch.cat(ws, dim=-1)
        serving = all(m._served is not None and m._served[1] is w
                      for m, w in zip(parts, ws))
        self._pts_weight = (ws, w_cat) if serving else None
        return w_cat

    def run_level(self, x):
        cls_feat, pts_feat = x, x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            pts_feat = conv(pts_feat)
        B, _, H, W = x.shape
        dt = x.dtype

        def conv3(conv):
            y = F.conv2d(pts_feat, conv.weight.to(dt), conv.bias.to(dt),
                         padding=1)
            return torch.relu(y).permute(0, 2, 3, 1)

        if self.with_keypoints:
            kpt_init = dense_1x1(conv3(self.keypts_init_conv),
                                 self.keypts_init_out)
        else:
            kpt_init = x.new_zeros((B, H, W, 2 * self.num_keypts))
        if self.own_rep_branch:
            rep_init = dense_1x1(conv3(self.reppts_init_conv),
                                 self.reppts_init_out)
        else:
            rep_init = dense_1x1(kpt_init, self.reppts_init_out)

        offs = grad_multiply(rep_init, self.gradient_mul)
        pos = absolute_positions(offs.reshape(B, H, W, self.num_reppts, 2),
                                 H, W)
        cls_nhwc = cls_feat.permute(0, 2, 3, 1).contiguous()
        pts_nhwc = pts_feat.permute(0, 2, 3, 1).contiguous()
        cls_col = torch.relu(deform_conv_fused(
            cls_nhwc, pos, self.cls_refine_dfmconv.tap_major(dt)))
        # the two pts-feature branches (kpt, rep) share one call through a
        # weight concat: the columns are gathered once for both
        parts = ([self.keypts_refine_dfmconv] if self.with_keypoints else []) \
            + ([self.reppts_refine_dfmconv] if self.own_rep_branch else [])
        w_cat = self.pts_weight(parts, dt)
        pts_col = torch.relu(deform_conv_fused(pts_nhwc, pos, w_cat))
        Fp = parts[0].weight.shape[0]

        def nhwc(t):
            return t.reshape(B, H, W, t.shape[-1])

        cls_out = nhwc(dense_1x1(cls_col, self.cls_refine_out))
        if self.with_keypoints:
            kpt_ref_raw = nhwc(dense_1x1(pts_col[..., :Fp],
                                         self.keypts_refine_out))
        else:
            kpt_ref_raw = torch.zeros_like(kpt_init)
        if self.own_rep_branch:
            rep_ref_raw = nhwc(dense_1x1(
                pts_col[..., Fp if self.with_keypoints else 0:],
                self.reppts_refine_out))
        else:
            rep_ref_raw = dense_1x1(kpt_ref_raw, self.reppts_refine_out)
        kpt_refine = kpt_ref_raw + kpt_init.detach()
        rep_refine = rep_ref_raw + rep_init.detach()
        return {
            'cls': torch.stack([cls_out]),
            'kpt': torch.stack([kpt_init, kpt_refine]),
            'bbox': torch.stack([self.to_bbox(rep_init),
                                 self.to_bbox(rep_refine)]),
            'rep': torch.stack([rep_init, rep_refine]),
        }

    def forward(self, feats):
        assert len(feats) == len(self.point_strides)
        return [self.run_level(x) for x in feats]
