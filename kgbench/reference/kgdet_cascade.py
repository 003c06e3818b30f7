"""Plain float32 reference of the KGDet cascade detector's forward pass.

ResNet-50 (pytorch style, frozen BatchNorm) -> FPN with GroupNorm, the
levels of ``select_out`` -> the three-stage keypoint-guided head of KGDet
(Qian et al., "KGDet: Keypoint-Guided Fashion Detection", AAAI 2021;
ShenhanQian/KGDet ``kgdet_moment_r50_fpn_1x-deepfashion2.py``):

- stage 1: two stacks of three 3x3 conv + GN + ReLU (classification and
  points), then a 3x3 conv + ReLU and a 1x1 output for the class logits and
  for the 2 * K keypoint offsets; a 1x1 conv turns the keypoints into the
  2 * R RepPoints offsets (R = 9 + 25 + 49);
- stages 2 and 3: the previous stage's RepPoints, (dy, dx) pairs in cells
  around each cell, are the taps of three deformable convolutions (3x3,
  5x5, 7x7 weights; 9, 25 and 49 taps, in that order) per branch; the
  columns are concatenated, ReLU, and the same three 1x1 outputs; keypoints
  and RepPoints add to the previous stage's;
- each stage's box is the moment transform of its RepPoints: centre at
  their mean, half extents their (n - 1) standard deviation (1e-6 inside
  the root) times ``exp(moment_transfer)``.

Gradients as the reference trains: the stem and the frozen stages take
none; the deformable stages' tap offsets pass ``gradient_mul`` of theirs,
the moment transfer ``moment_mul``; the residual sums take none into the
previous stage.

Deformable sampling is ``F.grid_sample`` (bilinear, zero outside the map,
``align_corners=True`` on cell centres), as the reference CUDA DCN kernel
lets a corner outside the map add nothing. Everything is float32 with TF32
off. ``quant`` is applied to both operands of every convolution and
contraction: the identity for the reference, a lower precision for the
control. Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

COLUMN_TAPS = (9, 25, 49)
STAGE_BLOCKS = {50: (3, 4, 6, 3)}


def _conv_spec(specs, name, cout, cin, k, bias):
    specs[f'{name}.weight'] = ((cout, cin, k, k), 'weight', cin * k * k)
    if bias:
        specs[f'{name}.bias'] = ((cout,), 'shift', 0)


def _bn_spec(specs, name, ch):
    specs[f'{name}.weight'] = ((ch,), 'scale', 0)
    specs[f'{name}.bias'] = ((ch,), 'shift', 0)
    specs[f'{name}.running_mean'] = ((ch,), 'shift', 0)
    specs[f'{name}.running_var'] = ((ch,), 'var', 0)
    specs[f'{name}.num_batches_tracked'] = ((), 'count', 0)


def _gn_spec(specs, name, ch):
    specs[f'{name}.weight'] = ((ch,), 'scale', 0)
    specs[f'{name}.bias'] = ((ch,), 'shift', 0)


def param_specs(m):
    """Every parameter and buffer of the model, under the reference
    checkpoint's names: name -> (shape, kind, fan_in). ``m`` is the
    configuration file's ``model`` object."""
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
    out, ins, start = nk['out_channels'], nk['in_channels'], \
        nk['start_level']
    used = len(ins) - start
    for i in range(used):
        _conv_spec(specs, f'neck.lateral_convs.{i}.conv', out,
                   ins[i + start], 1, False)
        _gn_spec(specs, f'neck.lateral_convs.{i}.gn', out)
    for i in range(nk['num_outs']):
        cin = ins[-1] if i == used else out
        _conv_spec(specs, f'neck.fpn_convs.{i}.conv', out, cin, 3, False)
        _gn_spec(specs, f'neck.fpn_convs.{i}.gn', out)
    h = m['head']
    fch, nkp, ncls = h['feat_channels'], h['num_keypts'], h['num_classes']
    specs['bbox_head.moment_transfer'] = ((2,), 'shift', 0)
    for br in ('cls', 'reg'):
        for i in range(h['stacked_convs']):
            cin = h['in_channels'] if i == 0 else fch
            _conv_spec(specs, f'bbox_head.{br}_convs.{i}.conv', fch, cin, 3,
                       False)
            _gn_spec(specs, f'bbox_head.{br}_convs.{i}.gn', fch)
    for s in (1, 2, 3):
        p = f'bbox_head.kp_rep_block_{s}'
        if s == 1:
            _conv_spec(specs, f'{p}.cls_conv', fch, fch, 3, True)
            _conv_spec(specs, f'{p}.keypts_conv', fch, fch, 3, True)
            cat = fch
        else:
            for br in ('cls', 'keypts'):
                for t in COLUMN_TAPS:
                    k = math.isqrt(t)
                    _conv_spec(specs, f'{p}.{br}_dfmconv_{k}', fch, fch, k,
                               False)
            cat = fch * len(COLUMN_TAPS)
        _conv_spec(specs, f'{p}.cls_out', ncls, cat, 1, True)
        specs[f'{p}.cls_out.bias'] = ((ncls,), 'prior', 0)
        _conv_spec(specs, f'{p}.keypts_out', 2 * nkp, cat, 1, True)
        _conv_spec(specs, f'{p}.reppts_out', 2 * sum(COLUMN_TAPS), 2 * nkp,
                   1, True)
    return specs


def _ident(t):
    return t


class _Net:
    """The forward pass over a dict of float32 weights."""

    def __init__(self, w, quant=None):
        self.w = w
        self.q = quant or _ident

    def conv(self, x, name, stride=1, pad=0):
        b = self.w.get(f'{name}.bias')
        return F.conv2d(self.q(x), self.q(self.w[f'{name}.weight']), b,
                        stride, pad)

    def bn(self, x, name):
        w = self.w
        inv = w[f'{name}.weight'] / torch.sqrt(w[f'{name}.running_var']
                                               + 1e-5)
        shift = w[f'{name}.bias'] - w[f'{name}.running_mean'] * inv
        return x * inv[:, None, None] + shift[:, None, None]

    def gn(self, x, name, groups):
        return F.group_norm(x, groups, self.w[f'{name}.weight'],
                            self.w[f'{name}.bias'], 1e-5)

    def block(self, x, p, stride, downsample):
        y = torch.relu(self.bn(self.conv(x, f'{p}.conv1'), f'{p}.bn1'))
        y = torch.relu(self.bn(self.conv(y, f'{p}.conv2', stride, 1),
                               f'{p}.bn2'))
        y = self.bn(self.conv(y, f'{p}.conv3'), f'{p}.bn3')
        if downsample:
            x = self.bn(self.conv(x, f'{p}.downsample.0', stride),
                        f'{p}.downsample.1')
        return torch.relu(y + x)

    def backbone(self, x, depth, frozen_stages):
        """C2..C5; the stem and the first ``frozen_stages`` stages take no
        gradient."""
        outs = []
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and frozen_stages < 0):
            x = torch.relu(self.bn(self.conv(x, 'backbone.conv1', 2, 3),
                                   'backbone.bn1'))
            x = F.max_pool2d(x, 3, 2, 1)
        for s, n in enumerate(STAGE_BLOCKS[depth]):
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and s >= frozen_stages):
                for i in range(n):
                    x = self.block(x, f'backbone.layer{s + 1}.{i}',
                                   2 if s > 0 and i == 0 else 1, i == 0)
            outs.append(x)
        return outs

    def neck(self, feats, nk):
        """The FPN levels of ``select_out`` below the backbone's top: the
        lateral 1x1 + GN, the nearest 2x top-down sum, the 3x3 + GN."""
        start, used = nk['start_level'], len(nk['in_channels']) - \
            nk['start_level']
        want = nk['select_out']
        if max(want) >= used:
            raise NotImplementedError('extra FPN levels are not referenced')
        g = nk['gn_groups']
        lo = min(want)
        lat = {i: self.gn(self.conv(feats[i + start],
                                    f'neck.lateral_convs.{i}.conv'),
                          f'neck.lateral_convs.{i}.gn', g)
               for i in range(lo, used)}
        for i in range(used - 1, lo, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(lat[i], scale_factor=2,
                                                    mode='nearest')
        return [self.gn(self.conv(lat[i], f'neck.fpn_convs.{i}.conv', 1, 1),
                        f'neck.fpn_convs.{i}.gn', g) for i in want]

    def deform_columns(self, feat, pos_yx, name):
        """feat (B, C, H, W); pos_yx (B, H, W, R, 2) absolute (y, x) cell
        positions -> (B, F * len(COLUMN_TAPS), H, W): per column, bilinear
        samples contracted with that column's weight."""
        B, C, H, W = feat.shape
        scale = torch.tensor([2.0 / max(W - 1, 1), 2.0 / max(H - 1, 1)],
                             device=feat.device)
        grid = (pos_yx.flip(-1) * scale - 1).reshape(B, H * W, -1, 2)
        outs, lo = [], 0
        for t in COLUMN_TAPS:
            cols = F.grid_sample(feat, grid[:, :, lo:lo + t], mode='bilinear',
                                 padding_mode='zeros', align_corners=True)
            lo += t
            wt = self.w[f'{name}_{math.isqrt(t)}.weight']
            wt = wt.reshape(wt.shape[0], C, t)              # taps row-major
            outs.append(torch.einsum('bcpt,fct->bfp', self.q(cols),
                                     self.q(wt)))
        return torch.cat(outs, 1).reshape(B, -1, H, W)

    def head_level(self, x, h):
        g = h['gn_groups']
        cls_feat = pts_feat = x
        for i in range(h['stacked_convs']):
            cls_feat = torch.relu(self.gn(self.conv(
                cls_feat, f'bbox_head.cls_convs.{i}.conv', 1, 1),
                f'bbox_head.cls_convs.{i}.gn', g))
            pts_feat = torch.relu(self.gn(self.conv(
                pts_feat, f'bbox_head.reg_convs.{i}.conv', 1, 1),
                f'bbox_head.reg_convs.{i}.gn', g))
        B, _, H, W = x.shape
        cells = torch.stack(torch.meshgrid(
            torch.arange(H, dtype=x.dtype, device=x.device),
            torch.arange(W, dtype=x.dtype, device=x.device),
            indexing='ij'), -1)                              # (H, W, 2) y, x
        stages, kpt, rep = [], None, None
        for s in (1, 2, 3):
            p = f'bbox_head.kp_rep_block_{s}'
            if s == 1:
                c = torch.relu(self.conv(cls_feat, f'{p}.cls_conv', 1, 1))
                k = torch.relu(self.conv(pts_feat, f'{p}.keypts_conv', 1, 1))
            else:
                # the offsets pass gradient_mul of their gradient
                g = h['gradient_mul']
                taps = g * rep + (1 - g) * rep.detach()
                pos = taps.permute(0, 2, 3, 1).reshape(B, H, W, -1, 2) \
                    + cells[None, :, :, None, :]
                c = torch.relu(self.deform_columns(cls_feat, pos,
                                                   f'{p}.cls_dfmconv'))
                k = torch.relu(self.deform_columns(pts_feat, pos,
                                                   f'{p}.keypts_dfmconv'))
            cls = self.conv(c, f'{p}.cls_out')
            kpt_s = self.conv(k, f'{p}.keypts_out')
            rep_s = self.conv(kpt_s, f'{p}.reppts_out')
            if s > 1:       # residual on the previous stage, detached
                kpt_s, rep_s = kpt_s + kpt.detach(), rep_s + rep.detach()
            kpt, rep = kpt_s, rep_s
            stages.append((cls, kpt, rep))

        def nhwc(t):
            return t.permute(0, 2, 3, 1)
        return {
            'cls': torch.stack([nhwc(c) for c, _, _ in stages]),
            'kpt': torch.stack([nhwc(k) for _, k, _ in stages]),
            'bbox': torch.stack([self.moment_box(nhwc(r), h['moment_mul'])
                                 for _, _, r in stages]),
        }

    def moment_box(self, rep, moment_mul):
        pts = rep.reshape(*rep.shape[:-1], -1, 2)
        py, px = pts[..., 0], pts[..., 1]
        n = px.shape[-1]
        std_x = torch.sqrt(px.var(-1, correction=1) + 1e-6)
        std_y = torch.sqrt(py.var(-1, correction=1) + 1e-6)
        mt = self.w['bbox_head.moment_transfer']
        mt = mt * moment_mul + mt.detach() * (1 - moment_mul)
        hw, hh = std_x * torch.exp(mt[0]), std_y * torch.exp(mt[1])
        mx, my = px.sum(-1) / n, py.sum(-1) / n
        return torch.stack([mx - hw, my - hh, mx + hw, my + hh], -1)


def forward(weights, image, model, quant=None):
    """image (B, 3, H, W) float32, normalized RGB, padding zero -> the head
    outputs of each selected level: dicts of cls (3, B, h, w, classes), kpt
    (3, B, h, w, 2K) and bbox (3, B, h, w, 4), every stage's."""
    net = _Net(weights, quant)
    feats = net.backbone(image, model['depth'], model['frozen_stages'])
    return [net.head_level(x, model['head'])
            for x in net.neck(feats, model['neck'])]


def fp8(t):
    """Rounds ``t`` to float8 e4m3 with one scale a tensor (its largest
    magnitude onto the format's 448), back in float32: the control's
    precision, the next below the configuration's bfloat16. The gradient
    passes the rounding unchanged."""
    d = t.detach()
    s = d.abs().amax().clamp(min=1e-30) / 448.0
    return t + ((d / s).to(torch.float8_e4m3fn).to(t.dtype) * s - d)
