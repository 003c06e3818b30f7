"""HRNet backbone (multi-branch high-resolution network).

Port of kgdet_tpu/models/hrnet.py on NCHW maps: two 3x3/2 stem convs, a
Bottleneck stage 1 (layer1), then three stages of HR modules, each a
BasicBlock chain a branch followed by the full fusion across resolutions
(1x1 conv + BN + nearest upsampling from a coarser branch, chains of 3x3/2
conv + BN (+ ReLU) from a finer one). A transition before each stage adds
one half-resolution branch. Names follow the reference's state_dict
(transition1.1.0.0, stage3.2.branches.1.3.conv1, stage3.0.fuse_layers.0.1.0,
...); the branch widths are W, 2W, 4W, 8W for ``width`` W (HRNetV2p-W18 /
W32 / W40), the block counts those of the published architecture.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import FrozenBatchNorm, _conv, \
    init_he_normal_
from kgdet_tpu_torch.models.resnet import BasicBlock, Bottleneck

# (modules, branches, blocks a branch) of stages 2 to 4
STAGE_PLAN = ((1, 2, 4), (4, 3, 4), (3, 4, 4))


class ConvBN(nn.Sequential):
    """conv (no bias) -> FrozenBatchNorm (-> ReLU): the reference's
    Sequential, so its children are named 0 and 1."""

    def __init__(self, cin: int, cout: int, k: int, stride: int,
                 relu: bool = True):
        super().__init__(nn.Conv2d(cin, cout, k, stride, k // 2, bias=False),
                         FrozenBatchNorm(cout))
        self.relu = relu

    def forward(self, x):
        conv, bn = self[0], self[1]
        y = bn(_conv(x, conv, conv.stride[0], conv.padding[0]))
        return torch.relu(y) if self.relu else y


class HRModule(nn.Module):
    """Branches of BasicBlocks, then the fusion of every branch into every
    other (``fuse_layers.<i>.<j>``), a ReLU after each sum."""

    def __init__(self, chans, num_blocks: int):
        super().__init__()
        n = len(chans)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(c, c) for _ in range(num_blocks)])
            for c in chans)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j == i:
                    row.append(None)
                elif j > i:         # coarser: 1x1 conv + BN, then upsample
                    row.append(ConvBN(chans[j], chans[i], 1, 1, relu=False))
                else:               # finer: i - j stride-2 convs
                    row.append(nn.Sequential(*[
                        ConvBN(chans[j], chans[i] if k == i - j - 1
                               else chans[j], 3, 2, relu=k < i - j - 1)
                        for k in range(i - j)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, feats):
        outs = [b(x) for b, x in zip(self.branches, feats)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = outs[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                t = layer(outs[j])
                if j > i:
                    t = F.interpolate(t, scale_factor=2 ** (j - i),
                                      mode='nearest')
                y = y + t
            fused.append(torch.relu(y))
        return fused


class HRNet(nn.Module):
    def __init__(self, width: int = 32, stage1_channels: int = 64,
                 stage1_blocks: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = FrozenBatchNorm(64)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if i == 0 else stage1_channels * 4,
                       stage1_channels, 1, downsample=i == 0)
            for i in range(stage1_blocks)])
        chans = self.branch_channels(width)
        pre = [stage1_channels * 4]
        for si, (num_modules, num_branches, num_blocks) in \
                enumerate(STAGE_PLAN):
            cur = list(chans[:num_branches])
            trans = []
            for i in range(num_branches):
                if i < len(pre):
                    trans.append(ConvBN(pre[i], cur[i], 3, 1)
                                 if pre[i] != cur[i] else None)
                else:
                    n_new = i + 1 - len(pre)
                    trans.append(nn.Sequential(*[
                        ConvBN(pre[-1], cur[i] if j == i - len(pre)
                               else pre[-1], 3, 2) for j in range(n_new)]))
            setattr(self, f'transition{si + 1}', nn.ModuleList(trans))
            setattr(self, f'stage{si + 2}', nn.ModuleList(
                HRModule(cur, num_blocks) for _ in range(num_modules)))
            pre = cur

    @staticmethod
    def branch_channels(width) -> Tuple[int, ...]:
        return (width, 2 * width, 4 * width, 8 * width)

    @classmethod
    def from_config(cls, bcfg):
        return cls(width=bcfg.hrnet_width)

    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_he_normal_(m.weight, gen)

    def forward(self, x):
        """x: (B, H, W, 3) NHWC in the compute dtype. Returns the four
        branches' maps (NCHW), finest first."""
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(_conv(x, self.conv1, 2, 1)))
        x = torch.relu(self.bn2(_conv(x, self.conv2, 2, 1)))
        feats = [self.layer1(x)]
        for si in range(len(STAGE_PLAN)):
            trans = getattr(self, f'transition{si + 1}')
            feats = [feats[i] if t is None else
                     t(feats[i] if i < len(feats) else feats[-1])
                     for i, t in enumerate(trans)]
            for module in getattr(self, f'stage{si + 2}'):
                feats = module(feats)
        return tuple(feats)
