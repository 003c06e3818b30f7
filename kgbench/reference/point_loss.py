"""Plain reference of the KGDet cascade's training loss (ShenhanQian/KGDet,
``kgdet_moment_r50_fpn_1x-deepfashion2.py``; the RepPoints point assigner
of Yang et al., ICCV 2019).

Targets, assigned once for all three stages: a garment belongs to the
pyramid level of ``trunc(mean(log2(w / scale), log2(h / scale)))``
clamped to the levels present; its candidates are the ``pos_num`` valid
cells of that level nearest its centre (distance over its width and
height; equal distances go to the lower cell); a cell that several
garments chose takes the nearest (the lower garment on ties). A positive
cell's targets are its garment's box, label and visible keypoints.

Loss, per stage: sigmoid focal loss of the class logits (gamma, alpha)
over the valid cells; smooth L1 (beta) of the box and of the keypoints,
each decoded to pixels (offset * stride + cell) and divided by
``point_base_scale * stride``; keypoint weights divided per cell by its
visible coordinate count, times 4; every term over the batch's positive
count (each image's at least 1), times the stage's weight. Float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

INF = 1e9


def cells(h, w, stride, device):
    """(P, 2) cell positions (x, y) in pixels, row-major."""
    ys, xs = torch.meshgrid(torch.arange(h, device=device),
                            torch.arange(w, device=device), indexing='ij')
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float() * stride


def valid_cells(h, w, stride, valid_hw):
    """(B, P) cells inside each image's resized extents."""
    vh = torch.ceil(valid_hw[:, 0].float() / stride)
    vw = torch.ceil(valid_hw[:, 1].float() / stride)
    dev = valid_hw.device
    row = torch.arange(h, device=dev)[None] < vh[:, None]
    col = torch.arange(w, device=dev)[None] < vw[:, None]
    return (row[:, :, None] & col[:, None, :]).reshape(len(valid_hw), -1)


def assign(xy, stride, valid, boxes, mask, scale, pos_num):
    """(assigned garment (B, P), positive (B, P)) for one level of cells
    ``xy`` (P, 2) at ``stride``; boxes (B, G, 4), mask (B, G)."""
    P = xy.shape[0]
    level = int(round(math.log2(stride)))
    ctr = (boxes[..., :2] + boxes[..., 2:]) / 2
    wh = (boxes[..., 2:] - boxes[..., :2]).clamp(min=1e-6)
    g_level = torch.trunc((torch.log2(wh[..., 0] / scale)
                           + torch.log2(wh[..., 1] / scale)) / 2)
    g_level = g_level.clamp(level, level)           # the one level present
    dist = torch.linalg.vector_norm(
        (xy[None, None] - ctr[:, :, None]) / wh[:, :, None], dim=-1)
    ok = (g_level[..., None] == level) & valid[:, None, :] & mask[..., None]
    dist = torch.where(ok, dist, torch.full_like(dist, INF))
    dist = dist + torch.arange(P, device=dist.device) * 1e-6
    kth = torch.topk(dist, min(pos_num, P), dim=-1, largest=False).values
    chosen = (dist <= kth[..., -1:]) & (dist < INF / 2)
    d = torch.where(chosen, dist, torch.full_like(dist, INF))
    best = d.amin(1)
    G = d.shape[1]
    order = torch.arange(G, device=d.device)[None, :, None]
    first = torch.where(d == best[:, None], order, G).amin(1)
    return first, best < INF / 2


def targets(xy, stride, valid, batch, scale, pos_num):
    boxes, labels = batch['gt_bboxes'].float(), batch['gt_labels'].long()
    kpts, mask = batch['gt_kpts'].float(), batch['gt_mask'].bool()
    a, pos = assign(xy, stride, valid, boxes, mask, scale, pos_num)
    B, P = a.shape
    K = kpts.shape[2]
    posf = pos.float()

    def take(t):
        idx = a.reshape(B, P, *([1] * (t.dim() - 2))).expand(B, P,
                                                             *t.shape[2:])
        return torch.gather(t, 1, idx)
    kp = take(kpts)
    vis = (kp[..., 2] != 0).float() * posf[..., None]
    return {
        'labels': torch.where(pos, take(labels), 0),
        'label_w': valid.float(),
        'box': take(boxes) * posf[..., None],
        'box_w': posf[..., None].expand(B, P, 4),
        'kpt': (kp[..., :2] * posf[..., None, None]).reshape(B, P, 2 * K),
        'kpt_w': vis.repeat_interleave(2, -1),
        'num_pos': pos.sum(1).clamp(min=1),
    }


def focal(logits, labels, weights, gamma, alpha):
    C = logits.shape[-1]
    t = F.one_hot((labels - 1).clamp(min=0), C).float() \
        * (labels > 0)[..., None].float()
    p = torch.sigmoid(logits)
    pt = (1 - p) * t + p * (1 - t)
    fw = (alpha * t + (1 - alpha) * (1 - t)) * pt ** gamma
    bce = logits.clamp(min=0) - logits * t + torch.log1p(
        torch.exp(-logits.abs()))
    return (bce * fw * weights[..., None]).sum()


def smooth_l1(pred, target, weights, beta):
    d = (pred - target).abs()
    return (torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
            * weights).sum()


def loss(level_outs, batch, model, canvas):
    """The total loss and its terms for one batch: image (B, ...), valid_hw
    (B, 2), gt_bboxes (B, G, 4), gt_labels (B, G), gt_kpts (B, G, K, 3),
    gt_mask (B, G); level_outs as kgdet_cascade.forward gives them."""
    h_cfg, L = model['head'], model['loss']
    dev = level_outs[0]['cls'].device
    tg, per_level = [], []
    for stride in h_cfg['point_strides']:
        h, w = math.ceil(canvas[0] / stride), math.ceil(canvas[1] / stride)
        xy = cells(h, w, stride, dev)
        valid = valid_cells(h, w, stride, batch['valid_hw'])
        per_level.append((xy, stride))
        tg.append(targets(xy, stride, valid, batch, L['assign_scale'],
                          L['pos_num']))
    avg = sum(t['num_pos'].sum() for t in tg).float()
    total, terms = 0.0, {}
    for (xy, stride), t, outs in zip(per_level, tg, level_outs):
        norm = L['point_base_scale'] * stride
        S, B = outs['cls'].shape[:2]
        P = xy.shape[0]
        kpt_w = t['kpt_w'].reshape(B * P, -1)
        n_vis = kpt_w.sum(1, keepdim=True)
        kpt_w = torch.where(n_vis > 0, kpt_w / n_vis.clamp(min=1), kpt_w) * 4
        for s in range(S):
            cls = outs['cls'][s].float().reshape(B * P, -1)
            l_cls = focal(cls, t['labels'].reshape(-1),
                          t['label_w'].reshape(-1), L['focal_gamma'],
                          L['focal_alpha']) / avg
            box = outs['bbox'][s].float().reshape(B, P, 4) * stride \
                + xy.repeat(1, 2)
            l_box = smooth_l1(box.reshape(-1, 4) / norm,
                              t['box'].reshape(-1, 4) / norm,
                              t['box_w'].reshape(-1, 4),
                              L['smooth_l1_beta']) / avg
            k = outs['kpt'][s].float().reshape(B, P, -1, 2).flip(-1)
            kxy = (k * stride + xy[None, :, None, :]).reshape(B * P, -1)
            l_kpt = smooth_l1(kxy / norm, t['kpt'].reshape(B * P, -1) / norm,
                              kpt_w, L['smooth_l1_beta']) / avg
            l_cls = l_cls * L['cls_weights'][s]
            l_box = l_box * L['bbox_weights'][s]
            l_kpt = l_kpt * L['kpt_weights'][s]
            terms.update({f'cls_{s + 1}': l_cls, f'bbox_{s + 1}': l_box,
                          f'kpt_{s + 1}': l_kpt})
            total = total + l_cls + l_box + l_kpt
    return total, terms
