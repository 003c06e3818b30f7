"""ResNet backbone (Bottleneck depths, pytorch style).

Port of kgdet_tpu/models/resnet.py. Module and
parameter names follow torchvision / the reference (conv1, bn1,
layer1.0.conv1, layer1.0.downsample.0, ...), so a reference .pth loads
with ``load_state_dict``.

With ``frozen_stages >= 1`` the stem, maxpool and layer1 run as the frozen
prefix ``ops/stem_kernels.py::stem_layer1_prepared`` (kernels K4 and K5)
under ``torch.no_grad()``, with FrozenBatchNorm folded into the convs; the
folded weights and the kernels' layout of them are made once and kept
(``ResNet.prefix_weights``). With
``prefix_pipeline=False`` (the JAX module's route when its whole-prefix
pipeline does not apply) the stem and maxpool are PyTorch calls and each
layer1 block is one ``ops/resblock.py::fused_bottleneck_prepared`` launch
(kernel K8) on the same kept weights. The stem is the plain 7x7/2 conv, not
the TPU's space-to-depth rewrite. layer2-4 are plain ``F.conv2d`` blocks.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import FrozenBatchNorm, init_he_normal_
from kgdet_tpu_torch.ops.resblock import bottleneck_reference, fold_bn, \
    fused_bottleneck_prepared
from kgdet_tpu_torch.ops.stem_kernels import prepare_block, prepare_stem, \
    stem_layer1_prepared, stem_layer1_ref

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
                 out_indices=(0, 1, 2, 3), frozen_stages: int = -1,
                 prefix_pipeline: bool = True):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise NotImplementedError(
                f'ResNet-{depth}: the port has Bottleneck depths '
                f'{sorted(STAGE_BLOCKS)}; BasicBlock depths are queued in '
                'ROADMAP Queue 1 item 5')
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.num_stages = num_stages
        self.prefix_pipeline = prefix_pipeline
        self.plain_prefix = False
        self._kept = None       # (key, folded, {dtype: prepared})
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

    def prefix_weights(self, dtype):
        """The frozen prefix's weights: (folded, prepared). ``folded``: the
        stem's f32 (w (7,7,3,64), b) with bn1 folded, and one dict of folded
        f32 weights a layer1 block (``Bottleneck.folded``); ``prepared``:
        the kernels' layout of them for inputs of ``dtype`` (the stem's
        ``prepare_stem``, one ``prepare_block`` a block, which K5 and K8
        share). Made once per device and dtype and kept; dropped by
        ``load_state_dict``, a move or cast of the module (``.to()``) and an
        in-place change of any parameter or buffer of conv1, bn1 or layer1
        (their ``_version``)."""
        tensors = [*self.conv1.parameters(), *self.bn1.parameters(),
                   *self.bn1.buffers(), *self.layer1.parameters(),
                   *self.layer1.buffers()]
        key = tuple((t.data_ptr(), t._version) for t in tensors)
        if self._kept is None or self._kept[0] != key:
            with torch.no_grad():
                stem = fold_bn(self.conv1.weight.permute(2, 3, 1, 0),
                               self.bn1.weight, self.bn1.bias,
                               self.bn1.running_mean, self.bn1.running_var,
                               self.bn1.eps)
                folded = (stem, [blk.folded() for blk in self.layer1])
            self._kept = (key, folded, {})
        _, folded, prepared = self._kept
        if dtype not in prepared:
            (sw, sb), blocks = folded
            prepared[dtype] = (prepare_stem(sw, sb, dtype),
                               [prepare_block(f, dtype) for f in blocks])
        return folded, prepared[dtype]

    def _apply(self, fn, *args, **kwargs):
        self._kept = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._kept = None
        return super()._load_from_state_dict(*args, **kwargs)

    def frozen_prefix(self, x):
        """Stem conv + BN + ReLU + maxpool + layer1, frozen. x (B,H,W,3) ->
        (B,H/4,W/4,256) NHWC. The kernel chain K4 -> K5 x len(layer1), or
        per block (``prefix_pipeline=False``): the stem and maxpool in
        PyTorch, then one K8 launch per layer1 block. Both read the kept
        weights of ``prefix_weights``; the plain chain (``plain_prefix``)
        computes from their folded f32 form."""
        with torch.no_grad():
            ((sw, sb), folded), (stem, blocks) = self.prefix_weights(x.dtype)
            if not self.prefix_pipeline:
                y = torch.relu(self.bn1(_conv(x.permute(0, 3, 1, 2),
                                              self.conv1, 2, 3)))
                y = F.max_pool2d(y, 3, 2, 1).permute(0, 2, 3, 1)
                for blk in blocks:
                    y = bottleneck_reference(y, *blk) if self.plain_prefix \
                        else fused_bottleneck_prepared(y, blk)
                return y
            if self.plain_prefix:
                return stem_layer1_ref(x, sw, sb, folded)
            return stem_layer1_prepared(x, stem, blocks)

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
            if self.frozen_stages == 0:
                x = x.detach()
            first = 0
        for stage in range(first, self.num_stages):
            x = getattr(self, f'layer{stage + 1}')(x)
            if stage + 1 == self.frozen_stages:
                x = x.detach()
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
