"""Plain float32 reference of Faster R-CNN R-50-FPN served, in stages:
the trunk and the RPN head (``forward``), the proposals (``proposals``)
and the RoI box head (``roi_head``); the decode of the box head's outputs
is ``rcnn_decode.py``.

mmdetection v1.x ``configs/faster_rcnn_r50_fpn_1x.py`` (the copy inside
ShenhanQian/KGDet), with DeepFashion2's 13 classes:

- ResNet-50, pytorch style, frozen BatchNorm (``kgdet_cascade._Net``'s
  trunk);
- FPN of 256 channels: P2 to P5 from C2 to C5 (1x1 lateral and 3x3
  output convs with biases, no norm, nearest 2x top-down sums), P6 a 1x1
  max-pool of stride 2 on P5;
- the RPN head on every level: a 3x3 conv of 256 and ReLU, 1x1 objectness
  (3 anchors) and 1x1 deltas (4 an anchor); anchors of scale 8 and ratios
  0.5, 1, 2, each level's base size its stride (4 to 64), tiled row-major
  over the level, anchor-minor;
- proposals: per level the 1,000 anchors of highest objectness (sigmoid;
  a stable sort, ties the lower anchor first), decoded (``delta2bbox``:
  means 0, stds 1, log-size deltas clipped at |log(16 / 1000)|, widths
  with the legacy +1), clamped to the resized image; a greedy NMS at IoU
  0.7 (+1 widths; ties the earlier candidate first), 1,000 kept an image;
- RoIAlign 7x7: each RoI on the level floor(log2(sqrt(w h) / 56 + 1e-6)),
  its corners scaled by the level's 1 / stride, its extent max(x2 - x1, 1)
  cells a side, 2 x 2 samples a bin at (i + (j + 0.5) / 2) bins from its
  corner, each a bilinear gather whose corners outside the map weigh 0,
  averaged; a missing RoI is zero;
- the shared 2FC head: the RoI flattened as (C, 7, 7), 12,544 -> 1,024 ->
  1,024 with ReLUs, 14 logits (background first) and 14 x 4 deltas.

Departures from mmdetection v1, where this reference follows the program
(``kgdet_tpu_torch``, and the JAX package before it): one NMS of the
proposals over all levels together (v1: an NMS a level, then the best
1,000 of their union), and a box of no width or height after the clamp is
never proposed; the base anchors are not rounded to whole pixels; the RoIs
are mapped onto all five levels P2 to P6 (v1's extractor reads P2 to P5)
by the side sqrt(w h) without the +1; RoIAlign weighs a corner outside the
map 0 and takes the extent without v1's extra pixel, where v1's kernel
clamps a sample near the border onto it; the test decode shares each
proposal's best-class box across the classes (``rcnn_decode.py``).

Everything is float32 (TF32 off, set by the caller), computed an image or a
level at a time. ``quant`` is applied to both operands of every convolution
and matrix product: the identity for the reference, a lower precision for
the control; ``dtype`` of ``proposals`` is that of its arithmetic. Imports
nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from kgbench.reference.kgdet_cascade import STAGE_BLOCKS, _bn_spec, \
    _conv_spec, _Net, fp8  # noqa: F401  (fp8: the control's precision)
from kgbench.reference.point_decode import _greedy, _iou_over

WH_RATIO_CLIP = 16 / 1000


def param_specs(m):
    """Every parameter and buffer of the model under the program's (the
    reference checkpoint's) names: name -> (shape, kind, fan_in)."""
    specs = {}
    _conv_spec(specs, 'backbone.conv1', 64, 3, 7, False)
    _bn_spec(specs, 'backbone.bn1', 64)
    cin, planes = 64, 64
    for s, n in enumerate(STAGE_BLOCKS[m['depth']]):
        for i in range(n):
            p = f'backbone.layer{s + 1}.{i}'
            _conv_spec(specs, f'{p}.conv1', planes, cin, 1, False)
            _bn_spec(specs, f'{p}.bn1', planes)
            _conv_spec(specs, f'{p}.conv2', planes, planes, 3, False)
            _bn_spec(specs, f'{p}.bn2', planes)
            _conv_spec(specs, f'{p}.conv3', planes * 4, planes, 1, False)
            _bn_spec(specs, f'{p}.bn3', planes * 4)
            if i == 0:
                _conv_spec(specs, f'{p}.downsample.0', planes * 4, cin, 1,
                           False)
                _bn_spec(specs, f'{p}.downsample.1', planes * 4)
            cin = planes * 4
        planes *= 2
    nk = m['neck']
    out = nk['out_channels']
    for i, c in enumerate(nk['in_channels']):
        _conv_spec(specs, f'neck.lateral_convs.{i}.conv', out, c, 1, True)
        _conv_spec(specs, f'neck.fpn_convs.{i}.conv', out, out, 3, True)
    r = m['rpn']
    a = len(r['anchor_scales']) * len(r['anchor_ratios'])
    _conv_spec(specs, 'rpn_head.rpn_conv', out, out, 3, True)
    _conv_spec(specs, 'rpn_head.rpn_cls', a, out, 1, True)
    _conv_spec(specs, 'rpn_head.rpn_reg', 4 * a, out, 1, True)
    h = m['roi']
    fc, ncls = h['fc_channels'], m['num_classes'] + 1
    fan = out * h['out_size'] ** 2
    for name, cout, cin in (('shared_fcs.0', fc, fan),
                            ('shared_fcs.1', fc, fc),
                            ('fc_cls', ncls, fc), ('fc_reg', 4 * ncls, fc)):
        specs[f'bbox_head.{name}.weight'] = ((cout, cin), 'weight', cin)
        specs[f'bbox_head.{name}.bias'] = ((cout,), 'shift', 0)
    return specs


def _fpn(net, c, nk):
    """P2.. from C2..: laterals, top-down sums, 3x3 outputs, then the
    max-pooled levels above the top."""
    used = len(nk['in_channels'])
    lat = [net.conv(c[i], f'neck.lateral_convs.{i}.conv')
           for i in range(used)]
    for i in range(used - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], scale_factor=2,
                                                mode='nearest')
    outs = [net.conv(lat[i], f'neck.fpn_convs.{i}.conv', 1, 1)
            for i in range(used)]
    for _ in range(nk['num_outs'] - used):
        outs.append(F.max_pool2d(outs[-1], 1, stride=2))
    return outs


def _rpn_level(net, x):
    t = torch.relu(net.conv(x, 'rpn_head.rpn_conv', 1, 1))
    return {'cls': net.conv(t, 'rpn_head.rpn_cls').permute(0, 2, 3, 1),
            'bbox': net.conv(t, 'rpn_head.rpn_reg').permute(0, 2, 3, 1)}


def forward(weights, image, model, quant=None):
    """image (B, 3, H, W) float32, normalized RGB, padding zero ->
    {'feats': the FPN levels (B, 256, h, w) from P2, 'rpn': per level
    cls (B, h, w, A) logits and bbox (B, h, w, 4A) deltas}."""
    net = _Net(weights, quant)
    c = net.backbone(image, model['depth'], model['frozen_stages'])
    feats = _fpn(net, c, model['neck'])
    return {'feats': feats, 'rpn': [_rpn_level(net, x) for x in feats]}


def anchors(model, canvas, device):
    """Per level the (h * w * A, 4) float32 anchors of a canvas: base
    anchors in float64 (scale-major within a ratio), cast, and shifted by
    the level's cell corners."""
    r = model['rpn']
    out = []
    for s in r['strides']:
        ctr = 0.5 * (s - 1)
        h_ratios = np.sqrt(np.asarray(r['anchor_ratios'], np.float64))
        scales = np.asarray(r['anchor_scales'], np.float64)
        ws = (s * (1.0 / h_ratios)[:, None] * scales[None, :]).reshape(-1)
        hs = (s * h_ratios[:, None] * scales[None, :]).reshape(-1)
        base = torch.as_tensor(np.stack(
            [ctr - 0.5 * (ws - 1), ctr - 0.5 * (hs - 1),
             ctr + 0.5 * (ws - 1), ctr + 0.5 * (hs - 1)], -1)
            .astype(np.float32), device=device)
        h, w = -(-canvas[0] // s), -(-canvas[1] // s)
        sx = (torch.arange(w, dtype=torch.float32, device=device)
              * s).repeat(h)
        sy = (torch.arange(h, dtype=torch.float32, device=device)
              * s).repeat_interleave(w)
        shifts = torch.stack([sx, sy, sx, sy], -1)
        out.append((base[None] + shifts[:, None]).reshape(-1, 4))
    return out


def delta2bbox(rois, deltas, stds):
    """(dx, dy, dw, dh) deltas times ``stds`` on xyxy boxes with +1
    widths; the log sizes clipped at |log(16 / 1000)|."""
    d = deltas * deltas.new_tensor(stds)
    clip = float(abs(np.log(WH_RATIO_CLIP)))
    dx, dy = d[..., 0], d[..., 1]
    dw, dh = d[..., 2].clamp(-clip, clip), d[..., 3].clamp(-clip, clip)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0] + 1.0
    ph = rois[..., 3] - rois[..., 1] + 1.0
    gw, gh = pw * torch.exp(dw), ph * torch.exp(dh)
    gx, gy = px + pw * dx, py + ph * dy
    return torch.stack([gx - gw * 0.5 + 0.5, gy - gh * 0.5 + 0.5,
                        gx + gw * 0.5 - 0.5, gy + gh * 0.5 - 0.5], -1)


def clamp_boxes(boxes, img_hw):
    """xyxy (B, N, 4) into [0, w] x [0, h] of each resized image."""
    w = img_hw[:, 1].to(boxes.dtype)[:, None]
    h = img_hw[:, 0].to(boxes.dtype)[:, None]
    return torch.stack([
        torch.minimum(boxes[..., 0].clamp(min=0), w),
        torch.minimum(boxes[..., 1].clamp(min=0), h),
        torch.minimum(boxes[..., 2].clamp(min=0), w),
        torch.minimum(boxes[..., 3].clamp(min=0), h)], -1)


def proposals(rpn_outs, level_anchors, img_hw, nms_pre=1000, max_num=1000,
              nms_thr=0.7, dtype=torch.float32):
    """rpn_outs: per level cls (B, h, w, A) and bbox (B, h, w, 4A);
    level_anchors from ``anchors``; img_hw (B, 2). Returns (proposals
    (B, max_num, 4) float32, zero where missing; valid (B, max_num))."""
    B = rpn_outs[0]['cls'].shape[0]
    lvl_boxes, lvl_scores = [], []
    for outs, anc in zip(rpn_outs, level_anchors):
        P = anc.shape[0]
        scores = torch.sigmoid(outs['cls'].to(dtype).reshape(B, P))
        reg = outs['bbox'].to(dtype).reshape(B, P, 4)
        k = min(nms_pre, P)
        top_s, top = torch.sort(scores, dim=-1, descending=True,
                                stable=True)
        top_s, top = top_s[:, :k], top[:, :k]
        boxes = clamp_boxes(delta2bbox(
            anc.to(dtype)[top], reg.gather(1, top[..., None].expand(B, k, 4)),
            (1.0,) * 4), img_hw)
        ok = (boxes[..., 2] - boxes[..., 0] > 0) \
            & (boxes[..., 3] - boxes[..., 1] > 0)
        lvl_scores.append(torch.where(ok, top_s, -math.inf))
        lvl_boxes.append(boxes)
    boxes = torch.cat(lvl_boxes, 1)
    scores = torch.cat(lvl_scores, 1).float().cpu().numpy()
    props = torch.zeros((B, max_num, 4), device=boxes.device)
    valid = torch.zeros((B, max_num), dtype=torch.bool, device=boxes.device)
    for b in range(B):
        kept = _greedy(scores[b], _iou_over(boxes[b], nms_thr), max_num)
        idx = torch.as_tensor(kept, dtype=torch.long, device=boxes.device)
        props[b, :len(kept)] = boxes[b, idx].float()
        valid[b, :len(kept)] = True
    return props, valid


def roi_levels(props, num_levels, finest_scale=56):
    """The level of each RoI (..., 4) by its side sqrt(w h)."""
    wh = (props[..., 2] - props[..., 0]) * (props[..., 3] - props[..., 1])
    scale = torch.sqrt(torch.clamp(wh, min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def _bilinear(feat, ys, xs):
    """feat (C, H, W) at rows ys (n, S) and columns xs (n, S) of each RoI's
    S x S grid -> (n, C, S, S); a corner outside the map weighs 0."""
    C, H, W = feat.shape
    flat = feat.reshape(C, H * W)
    y, x = ys[:, :, None], xs[:, None, :]
    y0, x0 = torch.floor(y), torch.floor(x)
    fy, fx = y - y0, x - x0
    out = 0.0
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            yy, xx = y0 + dy, x0 + dx
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).long()
            wt = torch.where(inside, wy * wx, 0.0)
            out = out + flat[:, idx] * wt                 # (C, n, S, S)
    return out.permute(1, 0, 2, 3)


def roi_align(feat, boxes, scale, out_size, sample_num):
    """feat (C, H, W); boxes (n, 4) xyxy in image pixels -> (n, C, out,
    out): each bin the mean of its sample_num^2 bilinear samples."""
    b = boxes * scale
    x1, y1 = b[:, 0], b[:, 1]
    rw = torch.clamp(b[:, 2] - x1, min=1.0)
    rh = torch.clamp(b[:, 3] - y1, min=1.0)
    i = torch.arange(out_size, dtype=torch.float32, device=feat.device)
    j = torch.arange(sample_num, dtype=torch.float32, device=feat.device)
    grid = (i[:, None] + (j[None, :] + 0.5) / sample_num).reshape(-1)
    ys = y1[:, None] + (rh / out_size)[:, None] * grid
    xs = x1[:, None] + (rw / out_size)[:, None] * grid
    v = _bilinear(feat, ys, xs)
    n, C = v.shape[:2]
    s = sample_num
    return v.reshape(n, C, out_size, s, out_size, s).mean((3, 5))


def roi_head(weights, feats, props, valid, model, quant=None, levels=None):
    """feats: the FPN levels (B, C, h, w); props (B, R, 4) in pixels of the
    resized image; valid (B, R). Each valid RoI aligned on its level
    (``levels`` (B, R) overrides the rule), every one of the R through the
    shared FCs -> (cls (B, R, classes + 1), reg (B, R, 4 (classes + 1)))."""
    q = quant or (lambda t: t)
    w = weights
    h = model['roi']
    strides = model['rpn']['strides']
    lvl = roi_levels(props, len(feats), h['finest_scale']) \
        if levels is None else levels
    B, R = props.shape[:2]
    C, n = feats[0].shape[1], h['out_size']
    cls, reg = [], []
    for b in range(B):
        x = feats[0].new_zeros((R, C, n, n))
        for li, (feat, stride) in enumerate(zip(feats, strides)):
            sel = ((lvl[b] == li) & valid[b]).nonzero()[:, 0]
            if len(sel):
                x[sel] = roi_align(feat[b], props[b, sel], 1.0 / stride, n,
                                   h['sample_num'])
        x = x.flatten(1)
        for i in range(2):
            p = f'bbox_head.shared_fcs.{i}'
            x = torch.relu(F.linear(q(x), q(w[f'{p}.weight']),
                                    w[f'{p}.bias']))
        cls.append(F.linear(q(x), q(w['bbox_head.fc_cls.weight']),
                            w['bbox_head.fc_cls.bias']))
        reg.append(F.linear(q(x), q(w['bbox_head.fc_reg.weight']),
                            w['bbox_head.fc_reg.bias']))
    return torch.stack(cls), torch.stack(reg)
