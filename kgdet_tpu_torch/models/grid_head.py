"""Grid R-CNN Plus grid head: point heatmaps in place of box regression.

Port of kgdet_tpu/models/grid_head.py (reference grid_head.py): an 8-conv
GroupNorm trunk (the first of stride 2), first- and second-order fusion of
the grid points' features over their neighbour graph (5x5 depthwise + 1x1
transitions), grouped deconvs to a half-size (28x28) heatmap a point;
sub-region targets, the heatmap loss, and boundary voting at decode. The
JAX head writes the grouped deconvs as per-point slices (flax has no
grouped ConvTranspose); here they are the reference's grouped
``ConvTranspose2d`` under its names (deconv1, norm1, deconv2), the same
function. flax's ConvTranspose(k=4, s=2, 'SAME') is torch's with
padding 1 on a spatially flipped kernel (the converter flips it).

Heatmaps go out as (N, 28, 28, P), the JAX layout.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import init_variance_scaling_, same_pad
from kgdet_tpu_torch.parallel.dist import global_sum


def grid_sub_regions(grid_points: int = 9, whole_map: int = 56):
    """(P, 2) (x1, y1) origins of each point's half-size window of the
    whole map (grid_head.py calc_sub_regions)."""
    gs = int(np.sqrt(grid_points))
    half = whole_map // 4 * 2

    def origin(idx):
        if idx == 0:
            return 0
        if idx == gs - 1:
            return half
        return max(int((idx / (gs - 1) - 0.25) * whole_map), 0)
    return np.asarray([(origin(i // gs), origin(i % gs))
                       for i in range(grid_points)], np.int32)


def grid_neighbors(grid_points: int = 9):
    """Each point's 4-neighbours on the gs x gs grid, in the reference's
    order (up, left, right, down)."""
    gs = int(np.sqrt(grid_points))
    out = []
    for i in range(gs):
        for j in range(gs):
            n = []
            if i > 0:
                n.append((i - 1) * gs + j)
            if j > 0:
                n.append(i * gs + j - 1)
            if j < gs - 1:
                n.append(i * gs + j + 1)
            if i < gs - 1:
                n.append((i + 1) * gs + j)
            out.append(tuple(n))
    return out


def _conv(x, conv, **kw):
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), **kw)


def _group_norm(x, gn):
    """GroupNorm with statistics in at least f32."""
    dt = torch.promote_types(x.dtype, torch.float32)
    return F.group_norm(x.to(dt), gn.num_groups, gn.weight.to(dt),
                        gn.bias.to(dt), gn.eps).to(x.dtype)


def _deconv(x, deconv):
    return F.conv_transpose2d(x, deconv.weight.to(x.dtype),
                              deconv.bias.to(x.dtype), stride=2, padding=1,
                              groups=deconv.groups)


class ConvGN(nn.Module):
    """3x3 conv (with a bias, as the flax conv; flax's 'SAME' padding, at
    the end only at stride 2) + GroupNorm (flax's epsilon) + ReLU, under
    the reference ConvModule's names."""

    def __init__(self, cin, cout, stride, groups):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride)
        self.gn = nn.GroupNorm(groups, cout, eps=1e-6)

    def forward(self, x):
        x = _conv(same_pad(x, 3, self.stride), self.conv, stride=self.stride)
        return torch.relu(_group_norm(x, self.gn))


def _transition(c):
    """The 5x5 depthwise + 1x1 transition (grid_head.py:115-135)."""
    return nn.Sequential(nn.Conv2d(c, c, 5, padding=2, groups=c),
                         nn.Conv2d(c, c, 1))


class GridHead(nn.Module):
    def __init__(self, grid_points=9, num_convs=8, in_channels=256,
                 point_feat_channels=64, gn_groups=36):
        super().__init__()
        P, c = grid_points, point_feat_channels
        self.grid_points, self.point_feat_channels = P, c
        self.neighbors = grid_neighbors(P)
        self.convs = nn.ModuleList(
            ConvGN(in_channels if i == 0 else P * c, P * c,
                   2 if i == 0 else 1, gn_groups) for i in range(num_convs))
        self.forder_trans = nn.ModuleList(
            nn.ModuleList(_transition(c) for _ in nbrs)
            for nbrs in self.neighbors)
        self.sorder_trans = nn.ModuleList(
            nn.ModuleList(_transition(c) for _ in nbrs)
            for nbrs in self.neighbors)
        self.deconv1 = nn.ConvTranspose2d(P * c, P * c, 4, stride=2,
                                          padding=1, groups=P)
        self.norm1 = nn.GroupNorm(P, P * c, eps=1e-6)
        self.deconv2 = nn.ConvTranspose2d(P * c, P, 4, stride=2, padding=1,
                                          groups=P)

    def init_weights(self, gen):
        """flax's defaults (lecun normal over the fan-in, zero biases, unit
        GroupNorm scales), the last deconv's bias at the 0.01 prior."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_variance_scaling_(m.weight, gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.ConvTranspose2d):
                # (Cin, Cout / groups, k, k): the fan-in of one group's
                # output, as flax's per-point ConvTranspose counts it
                fan_in = m.weight.shape[0] // m.groups \
                    * m.weight[0, 0].numel()
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                with torch.no_grad():
                    m.weight.copy_(nn.init.trunc_normal_(
                        torch.empty(m.weight.shape), std=std, a=-2 * std,
                        b=2 * std, generator=gen))
                nn.init.zeros_(m.bias)
        nn.init.constant_(self.deconv2.bias, -math.log(0.99 / 0.01))

    def _fuse(self, trans, src, base):
        out = []
        for i, nbrs in enumerate(self.neighbors):
            acc = base[i]
            for j, p in enumerate(nbrs):
                dw, pw = trans[i][j]
                t = _conv(src[p], dw, padding=2, groups=dw.groups)
                acc = acc + _conv(t, pw)
            out.append(acc)
        return out

    def _deconvs(self, slices):
        u = torch.relu(_group_norm(_deconv(torch.cat(slices, 1),
                                           self.deconv1), self.norm1))
        return _deconv(u, self.deconv2)

    def forward(self, x, train=True):
        """x (N, roi, roi, C) -> (fused, unfused) heatmaps, each (N, half,
        half, grid_points); at test (``train`` False) unfused is fused."""
        h = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            h = conv(h)
        c = self.point_feat_channels
        slices = list(h.split(c, dim=1))
        fo = self._fuse(self.forder_trans, slices, slices)
        so = self._fuse(self.sorder_trans, fo, slices)
        fused = self._deconvs(so).permute(0, 2, 3, 1)
        if not train:
            return fused, fused
        return fused, self._deconvs(slices).permute(0, 2, 3, 1)


def grid_targets(pos_boxes, gt_boxes, grid_points: int = 9,
                 whole_map: int = 56, radius: int = 1):
    """(R, half, half, P) sub-region heatmap targets (grid_head.py
    get_target, vectorized) of the RoIs pos_boxes (R, 4) and their
    assigned ground truths gt_boxes (R, 4); also the (R,) validity (the
    2x-expanded RoI larger than the grid)."""
    gs = int(np.sqrt(grid_points))
    half = whole_map // 4 * 2
    dev = pos_boxes.device
    sub = torch.as_tensor(grid_sub_regions(grid_points, whole_map),
                          device=dev).long()
    w = pos_boxes[:, 2] - pos_boxes[:, 0]
    h = pos_boxes[:, 3] - pos_boxes[:, 1]
    x1 = pos_boxes[:, 0] - w / 2
    y1 = pos_boxes[:, 1] - h / 2
    valid = (2 * w > gs) & (2 * h > gs)
    factors = torch.tensor(
        [(1 - (j // gs) / (gs - 1), 1 - (j % gs) / (gs - 1))
         for j in range(grid_points)], dtype=torch.float32, device=dev)
    fx, fy = factors[None, :, 0], factors[None, :, 1]
    gx = fx * gt_boxes[:, 0:1] + (1 - fx) * gt_boxes[:, 2:3]      # (R, P)
    gy = fy * gt_boxes[:, 1:2] + (1 - fy) * gt_boxes[:, 3:4]
    cx = torch.floor((gx - x1[:, None]) / (2 * w[:, None]).clamp(min=1e-6)
                     * whole_map).long()
    cy = torch.floor((gy - y1[:, None]) / (2 * h[:, None]).clamp(min=1e-6)
                     * whole_map).long()
    ar = torch.arange(half, device=dev)
    ix = ar[None, None, None, :] + sub[None, :, 0, None, None]
    iy = ar[None, None, :, None] + sub[None, :, 1, None, None]
    d2 = (ix - cx[:, :, None, None]) ** 2 + (iy - cy[:, :, None, None]) ** 2
    inside = ((cx >= 0) & (cx < whole_map)
              & (cy >= 0) & (cy < whole_map))[:, :, None, None]
    t = ((d2 <= radius * radius) & inside
         & valid[:, None, None, None]).float()
    return t.permute(0, 2, 3, 1), valid


def grid_loss(fused, unfused, targets, pos_weights, loss_weight=15.0):
    """Sigmoid BCE on both heatmaps over the positive RoIs (grid_head.py
    loss; CrossEntropyLoss(use_sigmoid, weight 15)); in a process group
    the positive count is summed over the processes."""
    def bce(logits):
        logits = logits.float()
        per = logits.clamp(min=0) - logits * targets + torch.log1p(
            torch.exp(-logits.abs()))
        per = per * pos_weights[:, None, None, None]
        denom = global_sum(pos_weights.sum()).clamp(min=1.0) * float(
            np.prod(logits.shape[1:]))
        return loss_weight * per.sum() / denom
    return bce(fused) + bce(unfused)


def grid_refine_boxes(heatmap, boxes, grid_points: int = 9,
                      whole_map: int = 56):
    """Boxes from the heatmaps by boundary voting (grid_head.py
    get_bboxes): heatmap (..., R, half, half, P) logits, boxes (..., R, 4)
    -> (..., R, 4)."""
    gs = int(np.sqrt(grid_points))
    half = whole_map // 4 * 2
    sub = torch.as_tensor(grid_sub_regions(grid_points, whole_map),
                          device=boxes.device)
    probs = torch.sigmoid(heatmap.float())
    flat = probs.movedim(-1, -3).flatten(-2)               # (..., R, P, hw)
    scores, pos = flat.max(-1)
    xs = pos % half + sub[:, 0]
    ys = torch.div(pos, half, rounding_mode='floor') + sub[:, 1]
    w = (boxes[..., 2] - boxes[..., 0])[..., None]
    h = (boxes[..., 3] - boxes[..., 1])[..., None]
    x1 = boxes[..., 0][..., None] - w / 2
    y1 = boxes[..., 1][..., None] - h / 2
    abs_x = (xs + 0.5) / half * w + x1
    abs_y = (ys + 0.5) / half * h + y1

    def vote(vals, inds):
        s = scores[..., inds]
        return (vals[..., inds] * s).sum(-1) / s.sum(-1).clamp(min=1e-6)
    x1i = list(range(gs))
    y1i = [i * gs for i in range(gs)]
    x2i = [grid_points - gs + i for i in range(gs)]
    y2i = [(i + 1) * gs - 1 for i in range(gs)]
    return torch.stack([vote(abs_x, x1i), vote(abs_y, y1i),
                        vote(abs_x, x2i), vote(abs_y, y2i)], dim=-1)
