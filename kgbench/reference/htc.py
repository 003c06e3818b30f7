"""Plain float32 reference of HTC R-50-FPN served (Hybrid Task Cascade,
Chen et al., CVPR 2019, arXiv:1901.07518), in stages: the trunk, the RPN
and the proposals (``faster_rcnn.forward``, ``faster_rcnn.proposals``),
the semantic branch (``semantic``), each box stage (``box_stage``, and
``next_rois`` between stages) and the three mask heads (``mask_heads``);
the decode with its masks is ``htc_decode.py``.

mmdetection v1.x ``configs/htc/htc_r50_fpn_1x.py`` (the copy inside
ShenhanQian/KGDet), with DeepFashion2's 13 classes and 183 stuff classes:

- the trunk, FPN P2 to P6, RPN and 1,000 proposals of
  ``faster_rcnn.py``;
- the semantic branch (``fused_semantic_head.py``): each level resized to
  the fusion level (P3, stride 8) and through a 1x1 lateral conv, the
  laterals summed, four 3x3 convs of 256 with ReLU, 1x1 stuff logits and
  a 1x1 embedding with ReLU;
- three box stages (``htc.py``): each RoI aligned 7x7 on its level, plus
  the semantic embedding aligned 7x7 at stride 8, through a 2FC head
  (12,544 -> 1,024 -> 1,024) with 14 logits and 4 class-agnostic deltas;
  each stage's deltas (stds 0.1 / 0.1 / 0.2 / 0.2, then halved, then a
  third) refine its RoIs, clamped to the image, into the next stage's;
- the mask RoIs: the last stage's boxes (its deltas decoded, unclamped),
  the 128 of highest mean foreground score over the three stages
  (``htc_decode.select``), each aligned 14x14 on its level plus the
  semantic embedding at 14x14;
- three mask heads with mask information flow (``htc_mask_head.py``):
  stage i > 0 adds a 1x1 conv of stage i - 1's features (taken after
  that stage's four 3x3 convs) to its input, before its own four 3x3
  convs (ReLU); then a 2x2 / 2 transposed conv with ReLU and 1x1
  logits of 14 channels, the background's dropped; the three stages'
  logits averaged.

Departures from the published HTC, where this reference follows the
program (``kgdet_tpu_torch``, and the JAX package before it), besides
those of ``faster_rcnn.py``: the box RoIs' semantic features are aligned
at 7x7 with 2 x 2 samples a bin (published: at 14x14, then average-pooled
to 7x7); the semantic laterals and ``conv_res`` have no ReLU (published:
``ConvModule``s with their default ReLU); the levels are resized as
``jax.image.resize``'s bilinear (a triangle filter widened by the
shrinking factor, so P2 is averaged over 4 x 4 cells; published:
``F.interpolate(..., 'bilinear', align_corners=True)``); the mask RoIs are
the 128 best boxes before the NMS (published: the NMS survivors, at most
100) and the stages' mask logits are averaged (published: their sigmoid
probabilities).

Everything is float32 (TF32 off, set by the caller), an image at a time
where RoIs are gathered. ``quant`` is applied to both operands of every
convolution and matrix product: the identity for the reference, a lower
precision for the control. Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from kgbench.reference import faster_rcnn
from kgbench.reference.faster_rcnn import anchors, clamp_boxes, \
    delta2bbox, forward, proposals, roi_align, roi_levels  # noqa: F401
from kgbench.reference.kgdet_cascade import _conv_spec, _ident, _Net, \
    fp8  # noqa: F401  (fp8: the control's precision)


def param_specs(m):
    """Every parameter and buffer of the model under the program's (the
    reference checkpoint's) names: name -> (shape, kind, fan_in)."""
    specs = {k: v for k, v in faster_rcnn.param_specs(m).items()
             if not k.startswith('bbox_head.')}
    C = m['neck']['out_channels']
    h = m['roi']
    fc, ncls = h['fc_channels'], m['num_classes'] + 1
    fan = C * h['out_size'] ** 2
    stages = len(m['cascade']['stds'])
    for s in range(stages):
        for name, cout, cin in (('shared_fcs.0', fc, fan),
                                ('shared_fcs.1', fc, fc),
                                ('fc_cls', ncls, fc), ('fc_reg', 4, fc)):
            specs[f'bbox_head.{s}.{name}.weight'] = ((cout, cin), 'weight',
                                                     cin)
            specs[f'bbox_head.{s}.{name}.bias'] = ((cout,), 'shift', 0)
    sm = m['semantic']
    for i in range(m['neck']['num_outs']):
        _conv_spec(specs, f'semantic_head.lateral_convs.{i}.conv', C, C, 1,
                   True)
    for i in range(sm['num_convs']):
        _conv_spec(specs, f'semantic_head.convs.{i}.conv', C, C, 3, True)
    _conv_spec(specs, 'semantic_head.conv_logits', sm['num_classes'], C, 1,
               True)
    _conv_spec(specs, 'semantic_head.conv_embedding.conv', C, C, 1, True)
    for s in range(stages):
        p = f'mask_head.{s}'
        if s > 0:
            _conv_spec(specs, f'{p}.conv_res.conv', C, C, 1, True)
        for i in range(m['mask']['num_convs']):
            _conv_spec(specs, f'{p}.convs.{i}.conv', C, C, 3, True)
        # a 2x2 / 2 transposed conv: each output pixel takes one tap of
        # every input channel
        specs[f'{p}.upsample.weight'] = ((C, C, 2, 2), 'weight', C)
        specs[f'{p}.upsample.bias'] = ((C,), 'shift', 0)
        _conv_spec(specs, f'{p}.conv_logits', ncls, C, 1, True)
    return specs


def resize_weights(n_in, n_out, device):
    """(n_out, n_in) float32 weights of ``jax.image.resize``'s bilinear
    along one axis: a triangle filter at each output's sample position
    (o + 0.5) n_in / n_out - 0.5, widened by n_in / n_out where that is
    above 1, each output's weights normalized to sum 1; an output whose
    sample lies outside [-0.5, n_in - 0.5] is 0."""
    scale = n_in / n_out
    pos = (torch.arange(n_out, dtype=torch.float64) + 0.5) * scale - 0.5
    dist = (pos[:, None] - torch.arange(n_in, dtype=torch.float64)).abs()
    w = (1.0 - dist / max(scale, 1.0)).clamp(min=0.0)
    w = w / w.sum(1, keepdim=True).clamp(min=1e-300)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return torch.where(inside[:, None], w, 0.0).float().to(device)


def resize(x, size):
    """(B, C, h, w) -> (B, C, *size), ``resize_weights`` along each axis."""
    wy = resize_weights(x.shape[2], size[0], x.device)
    wx = resize_weights(x.shape[3], size[1], x.device)
    return torch.einsum('yh,bchw,xw->bcyx', wy, x, wx)


def semantic(weights, feats, model, quant=None):
    """feats: the FPN levels (B, C, h, w) from P2 -> (stuff logits
    (B, H, W, classes), embedding (B, H, W, C)) at the fusion level."""
    net = _Net(weights, quant)
    sm = model['semantic']
    fl = sm['fusion_level']
    size = feats[fl].shape[2:]
    x = net.conv(feats[fl], f'semantic_head.lateral_convs.{fl}.conv')
    for i, f in enumerate(feats):
        if i != fl:
            x = x + net.conv(resize(f, size),
                             f'semantic_head.lateral_convs.{i}.conv')
    for i in range(sm['num_convs']):
        x = torch.relu(net.conv(x, f'semantic_head.convs.{i}.conv', 1, 1))
    logits = net.conv(x, 'semantic_head.conv_logits')
    emb = torch.relu(net.conv(x, 'semantic_head.conv_embedding.conv'))
    return logits.permute(0, 2, 3, 1), emb.permute(0, 2, 3, 1)


def roi_feats(feats, emb, rois, valid, model, out_size, levels=None):
    """Each valid RoI (B, R, 4) aligned ``out_size`` square on its level
    (``levels`` (B, R) overrides the rule) plus the semantic embedding
    (B, H, W, C) aligned at its stride -> (B, R, C, out, out); a missing
    RoI is zero."""
    h = model['roi']
    strides = model['rpn']['strides']
    lvl = roi_levels(rois, len(feats), h['finest_scale']) \
        if levels is None else levels
    B, R = rois.shape[:2]
    x = feats[0].new_zeros((B, R, feats[0].shape[1], out_size, out_size))
    for b in range(B):
        ok = valid[b].nonzero()[:, 0]
        if len(ok):
            x[b, ok] = roi_align(emb[b].permute(2, 0, 1), rois[b, ok],
                                 1.0 / model['semantic']['stride'],
                                 out_size, h['sample_num'])
        for li, (feat, stride) in enumerate(zip(feats, strides)):
            sel = ((lvl[b] == li) & valid[b]).nonzero()[:, 0]
            if len(sel):
                x[b, sel] = roi_align(feat[b], rois[b, sel], 1.0 / stride,
                                      out_size, h['sample_num']) + x[b, sel]
    return x


def box_stage(weights, feats, emb, rois, valid, model, stage, quant=None,
              levels=None):
    """Box stage ``stage`` on its RoIs (B, R, 4), every one of the R
    through the 2FC head -> (cls (B, R, classes + 1), reg (B, R, 4))."""
    q = quant or _ident
    w = weights
    p = f'bbox_head.{stage}'
    x = roi_feats(feats, emb, rois, valid, model, model['roi']['out_size'],
                  levels).flatten(2)
    for i in range(2):
        x = torch.relu(F.linear(q(x), q(w[f'{p}.shared_fcs.{i}.weight']),
                                w[f'{p}.shared_fcs.{i}.bias']))
    return (F.linear(q(x), q(w[f'{p}.fc_cls.weight']), w[f'{p}.fc_cls.bias']),
            F.linear(q(x), q(w[f'{p}.fc_reg.weight']), w[f'{p}.fc_reg.bias']))


def next_rois(rois, reg, img_hw, model, stage):
    """Stage ``stage``'s RoIs refined by its deltas, clamped to the resized
    images: the next stage's RoIs."""
    return clamp_boxes(delta2bbox(rois, reg, model['cascade']['stds'][stage]),
                       img_hw)


def mask_heads(weights, feats, emb, boxes, valid, model, quant=None,
               info_flow=True):
    """The mask heads on the mask RoIs (B, K, 4) -> the stages' logits
    averaged (B, K, 2 out, 2 out, classes). ``info_flow`` False leaves out
    every stage's ``conv_res`` (a fault)."""
    q = quant or _ident
    net, w = _Net(weights, quant), weights
    mk = model['mask']
    x = roi_feats(feats, emb, boxes, valid, model, mk['out_size'])
    B, K = x.shape[:2]
    x = x.flatten(0, 1)
    stages = len(model['cascade']['stds'])
    feat, total = None, 0.0
    for s in range(stages):
        p = f'mask_head.{s}'
        y = x
        if feat is not None and info_flow:
            y = y + net.conv(feat, f'{p}.conv_res.conv')
        for i in range(mk['num_convs']):
            y = torch.relu(net.conv(y, f'{p}.convs.{i}.conv', 1, 1))
        feat = y
        y = torch.relu(F.conv_transpose2d(q(y), q(w[f'{p}.upsample.weight']),
                                          w[f'{p}.upsample.bias'], stride=2))
        total = total + net.conv(y, f'{p}.conv_logits')[:, 1:]
    out = (total / stages).permute(0, 2, 3, 1)
    return out.reshape(B, K, *out.shape[1:])
