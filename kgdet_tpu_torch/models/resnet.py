"""ResNet backbone (Bottleneck depths, pytorch style).

Port of kgdet_tpu/models/resnet.py for the serving path. Module and
parameter names follow torchvision / the reference (conv1, bn1,
layer1.0.conv1, layer1.0.downsample.0, ...), so a reference .pth loads
with ``load_state_dict``.

With ``frozen_stages >= 1`` the stem, maxpool and layer1 run as the frozen
prefix ``ops/stem_kernels.py::stem_layer1`` (kernels K4 and K5) under
``torch.no_grad()``, with FrozenBatchNorm folded into the convs. The stem is
the plain 7x7/2 conv, not the TPU's space-to-depth rewrite. layer2-4 are
plain ``F.conv2d`` blocks.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import FrozenBatchNorm, init_he_normal_
from kgdet_tpu_torch.ops.resblock import fold_bn
from kgdet_tpu_torch.ops.stem_kernels import stem_layer1, stem_layer1_ref

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _conv(x, conv, stride=1, padding=0):
    return F.conv2d(x, conv.weight.to(x.dtype), stride=stride,
                    padding=padding)


class Bottleneck(nn.Module):
    """Pytorch-style bottleneck: the stride sits on the 3x3 conv."""
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.stride = stride
        self.conv1 = nn.Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
            FrozenBatchNorm(out_ch)) if downsample else None

    def forward(self, x):
        out = torch.relu(self.bn1(_conv(x, self.conv1)))
        out = torch.relu(self.bn2(_conv(out, self.conv2, self.stride, 1)))
        out = self.bn3(_conv(out, self.conv3))
        identity = x if self.downsample is None else self.downsample[1](
            _conv(x, self.downsample[0], self.stride))
        return torch.relu(out + identity)

    def folded(self):
        """Folded weights in the ops/resblock.py convention (stride-1
        blocks): w1 (Cin, width), w2 (3,3,width,width), w3 (width, Cout),
        wd (Cin, Cout); f32."""
        def fold(conv, bn):
            return fold_bn(conv.weight.permute(2, 3, 1, 0), bn.weight,
                           bn.bias, bn.running_mean, bn.running_var, bn.eps)
        w1, b1 = fold(self.conv1, self.bn1)
        w2, b2 = fold(self.conv2, self.bn2)
        w3, b3 = fold(self.conv3, self.bn3)
        blk = {'w1': w1[0, 0], 'b1': b1, 'w2': w2, 'b2': b2,
               'w3': w3[0, 0], 'b3': b3}
        if self.downsample is not None:
            wd, bd = fold(*self.downsample)
            blk['wd'], blk['bd'] = wd[0, 0], bd
        return blk


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices=(0, 1, 2, 3), frozen_stages: int = -1):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise NotImplementedError(
                f'ResNet-{depth}: the port has Bottleneck depths '
                f'{sorted(STAGE_BLOCKS)}; BasicBlock depths are queued in '
                'ROADMAP Queue 1 item 5')
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.num_stages = num_stages
        self.plain_prefix = False
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch, planes = 64, 64
        for stage in range(num_stages):
            blocks = []
            for i in range(STAGE_BLOCKS[depth][stage]):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(Bottleneck(
                    in_ch, planes, stride,
                    downsample=(i == 0 and (stride != 1 or
                                            in_ch != planes * 4))))
                in_ch = planes * 4
            setattr(self, f'layer{stage + 1}', nn.Sequential(*blocks))
            planes *= 2

    @classmethod
    def from_config(cls, bcfg):
        extras = (bcfg.dcn_stages or bcfg.gcb_stages or bcfg.nonlocal_stages
                  or bcfg.gen_attention_stages or bcfg.groups != 1
                  or bcfg.style != 'pytorch' or bcfg.type != 'ResNet')
        if extras:
            raise NotImplementedError(
                'backbone options beyond a plain pytorch-style ResNet '
                '(DCN, plugins, ResNeXt, caffe style) are queued in ROADMAP '
                'Queue 1 item 5')
        return cls(depth=bcfg.depth, num_stages=bcfg.num_stages,
                   out_indices=bcfg.out_indices,
                   frozen_stages=bcfg.frozen_stages)

    def init_weights(self, gen: torch.Generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_he_normal_(m.weight, gen)

    def frozen_prefix(self, x):
        """Stem conv + BN + ReLU + maxpool + layer1 as the kernel chain
        K4 -> K5 x len(layer1). x (B,H,W,3) -> (B,H/4,W/4,256) NHWC."""
        with torch.no_grad():
            sw, sb = fold_bn(self.conv1.weight.permute(2, 3, 1, 0),
                             self.bn1.weight, self.bn1.bias,
                             self.bn1.running_mean, self.bn1.running_var,
                             self.bn1.eps)
            blocks = [blk.folded() for blk in self.layer1]
            run = stem_layer1_ref if self.plain_prefix else stem_layer1
            return run(x, sw, sb, blocks)

    def forward(self, x):
        """x: (B, H, W, 3) NHWC in the compute dtype. Returns the
        out_indices stage outputs as NCHW tensors."""
        outs = []
        if self.frozen_stages >= 1:
            # NHWC -> NCHW view: channels_last memory, no copy
            x = self.frozen_prefix(x).permute(0, 3, 1, 2)
            first = 1
            if 0 in self.out_indices:
                outs.append(x)
        else:
            x = x.permute(0, 3, 1, 2)
            x = torch.relu(self.bn1(_conv(x, self.conv1, 2, 3)))
            x = F.max_pool2d(x, 3, 2, 1)
            first = 0
        for stage in range(first, self.num_stages):
            x = getattr(self, f'layer{stage + 1}')(x)
            if stage + 1 == self.frozen_stages:
                x = x.detach()
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
