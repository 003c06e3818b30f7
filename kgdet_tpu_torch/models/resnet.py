"""ResNet / ResNeXt backbones (BasicBlock depths 18 / 34, Bottleneck
depths 50 / 101 / 152; pytorch or caffe style).

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
the TPU's space-to-depth rewrite. The prefix takes the JAX module's gate:
Bottleneck blocks, ``groups == 1`` and no DCN or plugin in stage 0 (caffe
style changes nothing there: layer1 has stride 1). Every other block is a
PyTorch block: ``style='caffe'`` puts a stage's stride on the first 1x1
conv; ``groups`` / ``base_width`` make the grouped ResNeXt bottleneck (3x3
width ``planes * base_width / 64 * groups``); in the stages of
``dcn_stages`` the 3x3 conv is a deformable conv (``DeformConv3x3``: DCN
v1, offsets from a zero-initialized ``conv2_offset`` at the conv's stride)
that samples through ``ops/deform.py::deform_sample``: kernel K6 forward
and K3 backward on the card, then one contraction, block-diagonal by group
for ResNeXt; ``gcb_stages``, ``nonlocal_stages`` and
``gen_attention_stages`` insert the plugins of models/plugins.py where the
JAX blocks do. A PyTorch block runs each conv and the FrozenBatchNorm after
it through ``models/layers.py::conv_frozen_bn``: folded into one conv in a
forward that records no gradient, the conv then the BN in training; the
BN after a deformable 3x3 stays a BN.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.kgdet_head import DeformConvWeight
from kgdet_tpu_torch.models.layers import FrozenBatchNorm, _conv, \
    conv_frozen_bn, init_he_normal_
from kgdet_tpu_torch.models.plugins import ContextBlock, \
    GeneralizedAttention, NonLocal2D
from kgdet_tpu_torch.ops.deform import deform_conv, deform_sample
from kgdet_tpu_torch.ops.resblock import bottleneck_reference, fold_bn, \
    fused_bottleneck_prepared
from kgdet_tpu_torch.ops.stem_kernels import prepare_block, prepare_stem, \
    stem_layer1_prepared, stem_layer1_ref

ARCH_SETTINGS = {
    18: ('basic', (2, 2, 2, 2)),
    34: ('basic', (3, 4, 6, 3)),
    50: ('bottleneck', (3, 4, 6, 3)),
    101: ('bottleneck', (3, 4, 23, 3)),
    152: ('bottleneck', (3, 8, 36, 3)),
}
PLUGINS = {'gcb': ('context_block', ContextBlock),
           'nonlocal': ('nonlocal_block', NonLocal2D),
           'gen_attention': ('gen_attention_block', GeneralizedAttention)}


# the 3x3 taps' (dy, dx) offsets from the output pixel, row-major
_TAP_GRID = tuple((ky - 1.0, kx - 1.0) for ky in range(3) for kx in range(3))


class DeformConv3x3(DeformConvWeight):
    """3x3 deformable conv, v1 (no modulation), one offset field, any
    stride: the DCN option of the backbone's blocks and GA-Retina's feature
    adaption. Holds the reference's DeformConv weight (F, C / groups, 3,
    3), read tap-major (DeformConvWeight.tap_major, kept while the module
    serves). forward(x (B, C, H, W), offsets (B, 18, Ho, Wo)) ->
    (B, F, Ho, Wo): the offsets, y-first (dy, dx) pairs a tap, are added to
    the 3x3 base grid and sampled around the output pixels' centres
    (``stride`` times the output index). With ``groups > 1`` (ResNeXt) the
    one column gather is contracted block-diagonally, channel group g of
    the columns with output group g (the grouped conv's layout), as one
    batched matmul. ``plain`` runs the kernels' plain versions (the
    comparison model)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 groups: int = 1):
        super().__init__(in_channels // groups, out_channels, 3)
        self.stride = stride
        self.groups = groups
        self.plain = False
        self.register_buffer('tap_grid', torch.tensor(_TAP_GRID),
                             persistent=False)

    def forward(self, x, offsets):
        B, _, Ho, Wo = offsets.shape
        rel = offsets.permute(0, 2, 3, 1).reshape(B, Ho, Wo, 9, 2) \
            + self.tap_grid
        feat, w = x.permute(0, 2, 3, 1), self.tap_major(x.dtype)
        g = self.groups
        if g == 1:
            out = deform_conv(feat, rel, w, stride=self.stride,
                              plain=self.plain)
            return out.permute(0, 3, 1, 2)
        cols = deform_sample(feat, rel, stride=self.stride,
                             plain=self.plain)              # (B, P, 9, C)
        P, C, Fo = cols.shape[1], cols.shape[3], w.shape[2]
        cols = cols.reshape(B * P, 9, g, C // g).permute(2, 0, 1, 3) \
            .reshape(g, B * P, 9 * (C // g))
        w = w.reshape(9, C // g, g, Fo // g).permute(2, 0, 1, 3) \
            .reshape(g, 9 * (C // g), Fo // g)
        out = torch.bmm(cols, w)                            # (g, BP, F/g)
        return out.permute(1, 0, 2).reshape(B, Ho, Wo, Fo) \
            .permute(0, 3, 1, 2)


class BasicBlock(nn.Module):
    """Two 3x3 convs (the stride on the first), ResNet-18 / 34."""
    expansion = 1

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, 1, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_ch, planes, 1, stride, bias=False),
            FrozenBatchNorm(planes)) if downsample else None

    def forward(self, x):
        out = torch.relu(conv_frozen_bn(x, self.conv1, self.bn1,
                                        self.stride, 1))
        out = conv_frozen_bn(out, self.conv2, self.bn2, 1, 1)
        identity = x if self.downsample is None else conv_frozen_bn(
            x, *self.downsample, self.stride)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """Bottleneck block: the stride on the 3x3 conv (pytorch style) or on
    the first 1x1 (``style='caffe'``). ``use_dcn`` makes the 3x3 a
    DeformConv3x3 with its offset conv ``conv2_offset``; ``groups`` and
    ``base_width`` the grouped ResNeXt 3x3; ``plugin`` adds
    GeneralizedAttention after the 3x3 (``gen_attention_block``), the
    context block after bn3 (``context_block``) or a non-local block after
    the residual sum (``nonlocal_block``), as the JAX block does."""
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, use_dcn: bool = False,
                 style: str = 'pytorch', plugin=None, groups: int = 1,
                 base_width: int = 4):
        super().__init__()
        out_ch = planes * self.expansion
        width = planes if groups == 1 \
            else int(planes * (base_width / 64)) * groups
        self.stride = stride
        self.c1s, self.c2s = (stride, 1) if style == 'caffe' else (1, stride)
        self.use_dcn = use_dcn
        self.plugin = plugin
        self.conv1 = nn.Conv2d(in_ch, width, 1, self.c1s, bias=False)
        self.bn1 = FrozenBatchNorm(width)
        if use_dcn:
            self.conv2_offset = nn.Conv2d(width, 18, 3, self.c2s, 1)
            self.conv2 = DeformConv3x3(width, width, self.c2s, groups)
        else:
            self.conv2 = nn.Conv2d(width, width, 3, self.c2s, 1,
                                   groups=groups, bias=False)
        self.bn2 = FrozenBatchNorm(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = nn.Sequential(
            nn.Conv2d(in_ch, out_ch, 1, stride, bias=False),
            FrozenBatchNorm(out_ch)) if downsample else None
        if plugin is not None:
            name, cls = PLUGINS[plugin]
            setattr(self, name, cls(width if plugin == 'gen_attention'
                                    else out_ch))

    def forward(self, x):
        out = torch.relu(conv_frozen_bn(x, self.conv1, self.bn1, self.c1s))
        if self.use_dcn:
            off = self.conv2_offset
            out = self.bn2(self.conv2(out, F.conv2d(
                out, off.weight.to(out.dtype), off.bias.to(out.dtype),
                self.c2s, 1)))
        else:
            out = conv_frozen_bn(out, self.conv2, self.bn2, self.c2s, 1)
        out = torch.relu(out)
        if self.plugin == 'gen_attention':
            out = self.gen_attention_block(out)
        out = conv_frozen_bn(out, self.conv3, self.bn3)
        if self.plugin == 'gcb':
            out = self.context_block(out)
        identity = x if self.downsample is None else conv_frozen_bn(
            x, *self.downsample, self.stride)
        out = torch.relu(out + identity)
        if self.plugin == 'nonlocal':
            out = self.nonlocal_block(out)
        return out

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
                 prefix_pipeline: bool = True, dcn_stages=(),
                 gcb_stages=(), nonlocal_stages=(), gen_attention_stages=(),
                 style: str = 'pytorch', groups: int = 1,
                 base_width: int = 4):
        super().__init__()
        block_type, stage_blocks = ARCH_SETTINGS[depth]
        block = BasicBlock if block_type == 'basic' else Bottleneck
        self.out_indices = tuple(out_indices)
        self.dcn_stages = tuple(dcn_stages)
        self.frozen_stages = frozen_stages
        self.num_stages = num_stages
        self.prefix_pipeline = prefix_pipeline
        self.plain_prefix = False
        self._kept = None       # (key, folded, {dtype: prepared})
        extras = (dcn_stages, gcb_stages, nonlocal_stages,
                  gen_attention_stages)
        # the frozen K4 + K5 prefix: the JAX module's gate
        self.use_prefix = (block is Bottleneck and frozen_stages >= 1
                           and num_stages >= 1 and groups == 1
                           and not any(0 in st for st in extras))
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_ch, planes = 64, 64
        for stage in range(num_stages):
            plugin = ('gcb' if stage in gcb_stages else
                      'nonlocal' if stage in nonlocal_stages else
                      'gen_attention' if stage in gen_attention_stages
                      else None)
            kw = {} if block is BasicBlock else dict(
                use_dcn=stage in self.dcn_stages, style=style,
                plugin=plugin, groups=groups, base_width=base_width)
            blocks = []
            for i in range(stage_blocks[stage]):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(
                    in_ch, planes, stride,
                    downsample=(i == 0 and (stride != 1 or in_ch !=
                                            planes * block.expansion)),
                    **kw))
                in_ch = planes * block.expansion
            setattr(self, f'layer{stage + 1}', nn.Sequential(*blocks))
            planes *= 2

    @staticmethod
    def stage_channels(depth):
        e = 1 if ARCH_SETTINGS[depth][0] == 'basic' else 4
        return [64 * e, 128 * e, 256 * e, 512 * e]

    @classmethod
    def from_config(cls, bcfg, groups=None):
        return cls(depth=bcfg.depth, num_stages=bcfg.num_stages,
                   out_indices=bcfg.out_indices,
                   frozen_stages=bcfg.frozen_stages,
                   dcn_stages=bcfg.dcn_stages, gcb_stages=bcfg.gcb_stages,
                   nonlocal_stages=bcfg.nonlocal_stages,
                   gen_attention_stages=bcfg.gen_attention_stages,
                   style=bcfg.style,
                   groups=bcfg.groups if groups is None else groups,
                   base_width=bcfg.base_width)

    def init_weights(self, gen: torch.Generator):
        """He-normal conv and DCN weights; zero offset convs, so that a DCN
        starts as the plain 3x3 conv; each plugin its own init."""
        for name, m in self.named_modules():
            if name.endswith('conv2_offset'):
                nn.init.zeros_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.Conv2d, DeformConvWeight)):
                init_he_normal_(m.weight, gen)
        for m in self.modules():
            if isinstance(m, tuple(cls for _, cls in PLUGINS.values())):
                m.init_weights(gen)

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
        if self.use_prefix:
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


class ResNeXt(ResNet):
    """The grouped-bottleneck ResNet, registered as its own backbone type
    as in the reference registry. A config's ``groups = 1`` means unset
    here: the canonical 32x4d recipe's 32."""

    @classmethod
    def from_config(cls, bcfg, groups=None):
        return super().from_config(
            bcfg, groups=bcfg.groups if bcfg.groups != 1 else 32)
