"""KGDet cascade head: keypoints drive multi-column deformable sampling.

Port of kgdet_tpu/models/kgdet_head.py. Three stages per
pyramid level:
  S1 (plain convs): cls logits, the 294-keypoint offset field, and the
     83-point RepPoints field derived from the keypoints by a 1x1 conv.
  S2/S3 (deformable): the previous stage's RepPoints are the tap positions
     of three deformable columns (9/25/49 taps; one column of
     ``num_reppts`` taps in the Kp1Rep ablation) per branch, run by
     ``deform_columns_dual``: kernel K1, 6 launches per stage, when no
     gradient is wanted; under differentiation one split gather (K2) in
     the forward and one sampling backward (K3) per stage. Keypoint and
     RepPoints outputs accumulate residually on the detached previous
     stage.

Names follow the reference head (cls_convs.<i>, reg_convs.<i>,
kp_rep_block_<n>.{cls_conv, cls_dfmconv_3, cls_out, ...},
moment_transfer). Outputs keep the JAX layout: per level a dict with
cls (3, B, H, W, classes), kpt (3, B, H, W, 2*keypoints) and
bbox (3, B, H, W, 4).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import ConvModule, bias_prior, \
    init_normal_
from kgdet_tpu_torch.ops.deform import absolute_positions, grad_multiply
from kgdet_tpu_torch.ops.deform_kernels import deform_columns_dual
from kgdet_tpu_torch.ops.points import points2bbox

COLUMN_TAPS = (9, 25, 49)


def dense_1x1(x, conv):
    """A 1x1 conv applied as a dense layer over the last axis of x."""
    dt = x.dtype
    w = conv.weight.reshape(conv.weight.shape[0], -1).to(dt)
    return F.linear(x, w, conv.bias.to(dt))


class DeformConvWeight(nn.Module):
    """Holds a reference DeformConv weight (F, C, k, k) (no bias)."""

    def __init__(self, in_channels: int, out_channels: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k))

    def tap_major(self, dtype):
        """(F, C, k, k) -> (k*k, C, F), taps row-major."""
        w = self.weight
        return w.reshape(w.shape[0], w.shape[1], -1).permute(2, 1, 0) \
            .to(dtype).contiguous()


def dfm_name(branch: str, taps, ci: int) -> str:
    """The reference's DCN weight names: multi-column heads suffix the
    kernel size (cls_dfmconv_3/5/7), the single-column Kp1Rep head does
    not."""
    if len(taps) == 1:
        return f'{branch}_dfmconv'
    return f'{branch}_dfmconv_{int(round(taps[ci] ** 0.5))}'


class KpRepBlock(nn.Module):
    """One cascade stage: (cls logits, keypoint offsets, reppoint offsets),
    each (B, H, W, ·)."""

    def __init__(self, deform: bool, in_channels: int, cls_out_channels: int,
                 feat_channels: int = 256, num_keypts: int = 294,
                 gradient_mul: float = 0.1,
                 column_taps: Sequence[int] = COLUMN_TAPS):
        super().__init__()
        self.deform = deform
        self.gradient_mul = gradient_mul
        self.column_taps = tuple(column_taps)
        self.plain = False
        n_rep = sum(self.column_taps)
        fch = feat_channels
        if deform:
            for branch in ('cls', 'keypts'):
                for ci, t in enumerate(self.column_taps):
                    setattr(self, dfm_name(branch, self.column_taps, ci),
                            DeformConvWeight(in_channels, fch,
                                             int(round(t ** 0.5))))
            fch = feat_channels * len(self.column_taps)
        else:
            self.cls_conv = nn.Conv2d(in_channels, feat_channels, 3,
                                      padding=1)
            self.keypts_conv = nn.Conv2d(in_channels, feat_channels, 3,
                                         padding=1)
        self.cls_out = nn.Conv2d(fch, cls_out_channels, 1)
        self.keypts_out = nn.Conv2d(fch, 2 * num_keypts, 1)
        self.reppts_out = nn.Conv2d(2 * num_keypts, 2 * n_rep, 1)

    def dfm_weights(self, branch, dtype):
        return [getattr(self, dfm_name(branch, self.column_taps, ci))
                .tap_major(dtype) for ci in range(len(self.column_taps))]

    def forward(self, cls_feat, pts_feat, reppts_offset=None):
        """Stage 1: NCHW features. Stages 2/3: NHWC (B, H, W, C) features
        and the previous RepPoints field (B, H, W, 2*sum(column_taps))."""
        if not self.deform:
            dt = cls_feat.dtype

            def conv3(x, conv):
                y = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                             padding=1)
                return torch.relu(y).permute(0, 2, 3, 1)

            cls_out = dense_1x1(conv3(cls_feat, self.cls_conv), self.cls_out)
            keypts_out = dense_1x1(conv3(pts_feat, self.keypts_conv),
                                   self.keypts_out)
            return cls_out, keypts_out, dense_1x1(keypts_out, self.reppts_out)

        B, H, W, C = cls_feat.shape
        dt = cls_feat.dtype
        offs = grad_multiply(reppts_offset, self.gradient_mul)
        offs = offs.reshape(B, H, W, sum(self.column_taps), 2)
        pos = absolute_positions(offs, H, W)
        cls_cat, kpt_cat = deform_columns_dual(
            cls_feat, pts_feat, pos, self.dfm_weights('cls', dt),
            self.dfm_weights('keypts', dt), self.column_taps,
            plain=self.plain)
        cls_out = dense_1x1(torch.relu(cls_cat), self.cls_out)
        keypts_out = dense_1x1(torch.relu(kpt_cat), self.keypts_out)
        reppts_out = dense_1x1(keypts_out, self.reppts_out)

        def nhwc(t):
            return t.reshape(B, H, W, t.shape[-1])
        return nhwc(cls_out), nhwc(keypts_out), nhwc(reppts_out)


class KGDetHead(nn.Module):
    """3-stage keypoint-guided cascade head over the selected levels."""

    def __init__(self, num_classes: int = 13, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 3,
                 num_keypts: int = 294, gradient_mul: float = 0.1,
                 point_strides: Sequence[int] = (32,),
                 transform_method: str = 'moment', moment_mul: float = 0.01,
                 flip_forward: bool = False,
                 flip_indices: Optional[Sequence[int]] = None,
                 norm: Optional[str] = 'gn', gn_groups: int = 32,
                 column_taps: Sequence[int] = COLUMN_TAPS):
        super().__init__()
        self.point_strides = tuple(point_strides)
        self.transform_method = transform_method
        self.moment_mul = moment_mul
        self.flip_forward = flip_forward
        self.flip_indices = flip_indices
        for prefix in ('cls', 'reg'):
            setattr(self, f'{prefix}_convs', nn.ModuleList(
                ConvModule(in_channels if i == 0 else feat_channels,
                           feat_channels, 3, norm=norm, gn_groups=gn_groups)
                for i in range(stacked_convs)))
        for i in range(3):
            setattr(self, f'kp_rep_block_{i + 1}', KpRepBlock(
                deform=i > 0, in_channels=feat_channels,
                cls_out_channels=num_classes, feat_channels=feat_channels,
                num_keypts=num_keypts, gradient_mul=gradient_mul,
                column_taps=column_taps))
        self.moment_transfer = nn.Parameter(torch.zeros(2)) \
            if transform_method == 'moment' else None

    @classmethod
    def from_config(cls, cfg, column_taps=COLUMN_TAPS):
        h = cfg.head
        flip_indices = None
        if h.flip_forward and h.num_keypts == 294:
            from kgdet_tpu_torch.data.deepfashion2_meta import \
                interleaved_flip_indices
            flip_indices = tuple(int(i) for i in interleaved_flip_indices())
        return cls(num_classes=h.num_classes, in_channels=h.in_channels,
                   feat_channels=h.feat_channels,
                   stacked_convs=h.stacked_convs, num_keypts=h.num_keypts,
                   gradient_mul=h.gradient_mul,
                   point_strides=h.point_strides,
                   transform_method=h.transform_method,
                   moment_mul=h.moment_mul, flip_forward=h.flip_forward,
                   flip_indices=flip_indices, norm=h.norm,
                   gn_groups=h.gn_groups, column_taps=column_taps)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, DeformConvWeight)):
                init_normal_(m.weight, 0.01, gen)
                if getattr(m, 'bias', None) is not None:
                    nn.init.zeros_(m.bias)
        for i in range(3):
            nn.init.constant_(getattr(self, f'kp_rep_block_{i + 1}')
                              .cls_out.bias, bias_prior(0.01))

    def to_bbox(self, reppts):
        return points2bbox(reppts.float(), self.transform_method,
                           self.moment_transfer, self.moment_mul)

    def run_level(self, x):
        cls_feat, pts_feat = x, x
        for conv in self.cls_convs:
            cls_feat = conv(cls_feat)
        for conv in self.reg_convs:
            pts_feat = conv(pts_feat)

        cls1, kpt1, rep1 = self.kp_rep_block_1(cls_feat, pts_feat)
        cls_nhwc = cls_feat.permute(0, 2, 3, 1).contiguous()
        pts_nhwc = pts_feat.permute(0, 2, 3, 1).contiguous()

        cls2, kpt2_raw, rep2_raw = self.kp_rep_block_2(cls_nhwc, pts_nhwc,
                                                       rep1)
        kpt2 = kpt2_raw + kpt1.detach()
        rep2 = rep2_raw + rep1.detach()

        cls3, kpt3_raw, rep3_raw = self.kp_rep_block_3(cls_nhwc, pts_nhwc,
                                                       rep2)
        kpt3 = kpt3_raw + kpt2.detach()
        rep3 = rep3_raw + rep2.detach()
        return {
            'cls': torch.stack([cls1, cls2, cls3]),
            'kpt': torch.stack([kpt1, kpt2, kpt3]),
            'bbox': torch.stack([self.to_bbox(rep1), self.to_bbox(rep2),
                                 self.to_bbox(rep3)]),
        }

    def fuse_flip(self, out, out_f):
        """Average with the flipped-input forward mapped back: cls maps flip
        back on W; keypoint offsets (y-first pairs) flip back, negate x and
        permute by flip_indices; boxes flip back, negate x, swap x1/x2."""
        K2 = out['kpt'].shape[-1]
        dev = out['kpt'].device
        flip_idx = torch.as_tensor(
            self.flip_indices if self.flip_indices is not None
            else range(K2), dtype=torch.long, device=dev)
        cls_b = out_f['cls'].flip(3)
        kpt_b = out_f['kpt'].flip(3)
        sign = torch.tensor([1.0, -1.0], dtype=kpt_b.dtype,
                            device=dev).repeat(K2 // 2)
        kpt_b = (kpt_b * sign)[..., flip_idx]
        bbox_b = out_f['bbox'].flip(3)
        bbox_b = torch.stack([-bbox_b[..., 2], bbox_b[..., 1],
                              -bbox_b[..., 0], bbox_b[..., 3]], dim=-1)
        return {
            'cls': (out['cls'] + cls_b) / 2,
            'kpt': (out['kpt'] + kpt_b) / 2,
            'bbox': (out['bbox'] + bbox_b) / 2,
        }

    def forward(self, feats):
        assert len(feats) == len(self.point_strides)
        outs = []
        for x in feats:
            out = self.run_level(x)
            if self.flip_forward:
                out = self.fuse_flip(out, self.run_level(x.flip(-1)))
            outs.append(out)
        return outs
