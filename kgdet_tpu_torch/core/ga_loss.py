"""Guided-anchoring targets, losses and decodes (GA-Retina, GA-RPN).

Port of kgdet_tpu/core/ga_loss.py, with the batch
dimension written out where the JAX package uses ``vmap``:
- location targets as region masks of each GT's shrunk centre (positive)
  and ignore band on its own level, the band also on the adjacent levels;
  a centre region wins over any GT's band;
- the approx assignment of the shape branch: a square's IoU with a GT is
  the best over its octave's approx anchors; each square takes its best GT
  (the first on ties, as jnp.argmax), and each GT claims the squares tied
  at its own best IoU (the last claiming GT wins, as in the JAX package);
  one image at a time, since the (G, P * A) IoU of a full canvas is large;
- the bounded-IoU shape loss, then focal classification and smooth-L1
  regression against MaxIoU targets on the detached guided anchors.
Every term is taken in f32. In a process group the location loss's
average factor (its share of the global batch's positions), the shape
loss's positive count and the cls / reg positive count are summed over the
processes (``global_sum``), as the JAX ``dp`` mesh counts the global batch.

GA-RPN (ga_rpn_head.py) shares the location and shape terms and adds
binary objectness and class-agnostic regression on the guided anchors with
the RPN's sampling (``ga_rpn_loss``: its uniforms come from the two-stage
loss's ``draw``, the RPN role), and decodes its proposals as the RPN does,
the location filter a zeroed score (``ga_rpn_proposals``).

Where the JAX package departs from the published recipe the port follows
it: ``target_stds`` of GA-Retina's cls / reg deltas default to 1.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from kgdet_tpu_torch.config import HeadConfig, TestConfig
from kgdet_tpu_torch.core.anchor_loss import clamp_to_image, \
    nms_detections, top_k_rows
from kgdet_tpu_torch.core.bbox_transforms import bbox2delta, delta2bbox
from kgdet_tpu_torch.core.iou_assign import assign_max_iou, iou_xyxy
from kgdet_tpu_torch.ops.anchors import anchor_valid_flags, base_anchors, \
    grid_anchors
from kgdet_tpu_torch.ops.losses import bounded_iou_loss, \
    sigmoid_focal_loss, smooth_l1_loss
from kgdet_tpu_torch.parallel.dist import global_sum

ANCHORING_STDS = (0.07, 0.07, 0.14, 0.14)
GA_RPN_TARGET_STDS = (0.07, 0.07, 0.11, 0.11)


def ga_squares(stride, octave_base, fh, fw, device=None):
    """(P, 4) square anchors of side octave_base * stride a position."""
    base = base_anchors(octave_base * stride, [1.0], [1.0],
                        ctr=((stride - 1) / 2.0, (stride - 1) / 2.0))
    return grid_anchors(base, fh, fw, stride, device=device)


def ga_approx_anchors(stride, octave_base, scales_per_octave, ratios,
                      fh, fw, device=None):
    """(P, A, 4) octave approx anchors a position (retina layout)."""
    scales = [octave_base * 2 ** (i / scales_per_octave)
              for i in range(scales_per_octave)]
    base = base_anchors(stride, scales, ratios)
    return grid_anchors(base, fh, fw, stride,
                        device=device).reshape(-1, base.shape[0], 4)


def _region_mask(boxes, fh, fw, ratio):
    """(..., G, fh, fw) mask of each box's ratio-shrunk centre region in
    feature-grid coordinates (round half to even, as jnp.round)."""
    def edge(a, b, hi):
        return torch.round((1 - ratio) * a + ratio * b).clamp(0, hi)
    x1 = edge(boxes[..., 0], boxes[..., 2], fw - 1)
    y1 = edge(boxes[..., 1], boxes[..., 3], fh - 1)
    x2 = edge(boxes[..., 2], boxes[..., 0], fw - 1)
    y2 = edge(boxes[..., 3], boxes[..., 1], fh - 1)
    ys = torch.arange(fh, device=boxes.device)[:, None]
    xs = torch.arange(fw, device=boxes.device)[None, :]
    return ((ys >= y1[..., None, None]) & (ys <= y2[..., None, None])
            & (xs >= x1[..., None, None]) & (xs <= x2[..., None, None]))


@torch.no_grad()
def ga_loc_targets(gt_bboxes, gt_mask, strides, featmap_sizes,
                   octave_base, center_ratio=0.2, ignore_ratio=0.5):
    """Per level (B, fh, fw) location targets and weights: positive in a
    GT's centre region on its own level (target 1, weight 1); ignored in
    its band there and in its centre and band on the adjacent levels
    (weight 0); elsewhere target 0, weight 0.1. Also returns this batch's
    loc_avg_factor sum(B * fh * fw) / 200, a Python float."""
    B = gt_mask.shape[0]
    r1 = (1 - center_ratio) / 2
    r2 = (1 - ignore_ratio) / 2
    scale = torch.sqrt(((gt_bboxes[..., 2] - gt_bboxes[..., 0] + 1)
                        * (gt_bboxes[..., 3] - gt_bboxes[..., 1] + 1))
                       .clamp(min=1.0))
    min_size = float(octave_base * strides[0])
    lvl = torch.floor(torch.log2(scale / min_size) + 0.5) \
        .clamp(0, len(strides) - 1).to(torch.int32)          # (B, G)

    targets, weights = [], []
    for li, (stride, (fh, fw)) in enumerate(zip(strides, featmap_sizes)):
        boxes = gt_bboxes / stride
        own = (gt_mask & (lvl == li))[..., None, None]
        adj = (gt_mask & ((lvl == li - 1) | (lvl == li + 1)))[..., None,
                                                                None]
        band = _region_mask(boxes, fh, fw, r2)
        pos = (_region_mask(boxes, fh, fw, r1) & own).any(dim=1)
        ignore = ((band & own).any(dim=1) | (band & adj).any(dim=1)) & ~pos
        t = pos.to(torch.float32)
        w = torch.where(pos, 1.0, torch.where(ignore, 0.0, 0.1))
        targets.append(t)
        weights.append(w)
    avg = sum(B * fh * fw for fh, fw in featmap_sizes) / 200.0
    return targets, weights, avg


@torch.no_grad()
def ga_approx_assign(approxs, valid, gt_bboxes, gt_mask, pos_iou_thr,
                     min_pos_iou):
    """The approx assignment of the squares, one image at a time: approxs
    (P, A, 4), valid (B, P), gt_bboxes (B, G, 4), gt_mask (B, G) ->
    (assigned GT (B, P) int64, positive (B, P) bool)."""
    P, A = approxs.shape[:2]
    G = gt_bboxes.shape[1]
    gt_ids = torch.arange(G, device=approxs.device)[:, None]
    assigned, pos_mask = [], []
    for v, gts, mask in zip(valid, gt_bboxes, gt_mask):
        iou = iou_xyxy(gts, approxs.reshape(-1, 4)).reshape(G, P, A) \
            .amax(dim=-1)
        ok = mask[:, None] & v[None, :]
        iou = torch.where(ok, iou, torch.full_like(iou, -1.0))
        max_iou = iou.amax(dim=0)
        argmax = torch.where(iou == max_iou, gt_ids, G).amin(dim=0)
        gt_best = iou.amax(dim=1)
        claims = (iou == gt_best[:, None]) \
            & (gt_best[:, None] >= min_pos_iou) & ok
        last = torch.where(claims, gt_ids, -1).amax(dim=0)
        assigned.append(torch.where(last >= 0, last, argmax))
        pos_mask.append(((max_iou >= pos_iou_thr) | (last >= 0)) & v)
    return torch.stack(assigned), torch.stack(pos_mask)


def _flat(level_outs, key, width):
    """The last stage of every level's ``key`` map as (B, P, width) f32
    over the concatenated levels."""
    B = level_outs[0][key].shape[1]
    return torch.cat([o[key][-1].float().reshape(B, -1, width)
                      for o in level_outs], dim=1)


def _guided(squares, shape_pred, stds=ANCHORING_STDS):
    """Squares (P, 4) resized by the (dw, dh) prediction (B, P, 2)."""
    deltas = torch.cat([torch.zeros_like(shape_pred), shape_pred], dim=-1)
    return delta2bbox(squares, deltas, stds=stds)


def ga_loc_shape_losses(level_outs, batch, head_cfg: HeadConfig,
                        assign_cfg, canvas_hw, center_ratio=0.2,
                        ignore_ratio=0.5, anchoring_stds=ANCHORING_STDS,
                        shape_weight=0.2):
    """The shared GA branches: the location focal loss, the bounded-IoU
    shape loss, and the detached guided anchors with their validity for
    the cls / reg targets. Returns (l_loc, l_shape, guided (B, P, 4),
    valid (B, P))."""
    strides = head_cfg.point_strides
    H, W = canvas_hw
    featmap_sizes = [(-(-H // s), -(-W // s)) for s in strides]
    gt_bboxes, gt_mask = batch['gt_bboxes'], batch['gt_mask']
    B, dev = gt_bboxes.shape[0], gt_bboxes.device

    loc_t, loc_w, loc_avg = ga_loc_targets(
        gt_bboxes, gt_mask, strides, featmap_sizes,
        head_cfg.octave_base_scale, center_ratio, ignore_ratio)
    loc_avg = global_sum(torch.tensor(loc_avg, device=dev))
    l_loc = 0.0
    for o, t, w in zip(level_outs, loc_t, loc_w):
        l_loc = l_loc + sigmoid_focal_loss(
            o['loc'][-1].float().reshape(-1, 1), t.reshape(-1).to(
                torch.int32), w.reshape(-1), gamma=head_cfg.focal_gamma,
            alpha=head_cfg.focal_alpha, avg_factor=loc_avg)

    squares = torch.cat([ga_squares(s, head_cfg.octave_base_scale, fh, fw,
                                    device=dev)
                         for s, (fh, fw) in zip(strides, featmap_sizes)])
    approxs = torch.cat([
        ga_approx_anchors(s, head_cfg.octave_base_scale,
                          head_cfg.scales_per_octave,
                          head_cfg.anchor_ratios, fh, fw, device=dev)
        for s, (fh, fw) in zip(strides, featmap_sizes)])
    valid_hw = batch['valid_hw']
    valid = torch.cat([
        anchor_valid_flags(fh, fw, 1,
                           torch.ceil(valid_hw[:, 0] / s).to(torch.int32),
                           torch.ceil(valid_hw[:, 1] / s).to(torch.int32))
        for s, (fh, fw) in zip(strides, featmap_sizes)], dim=1)
    shape_pred = _flat(level_outs, 'shape', 2)              # (B, P, 2)

    assigned, pos_mask = ga_approx_assign(
        approxs, valid, gt_bboxes, gt_mask, assign_cfg.pos_iou_thr,
        assign_cfg.min_pos_iou)
    pred_anchors = _guided(squares, shape_pred, anchoring_stds)
    gt_per_sq = torch.gather(gt_bboxes, 1,
                             assigned[..., None].expand(-1, -1, 4))
    posf = pos_mask.to(torch.float32)
    l_shape = bounded_iou_loss(
        pred_anchors, gt_per_sq, weights=posf[..., None], beta=0.2,
        avg_factor=global_sum(posf.sum()).clamp(min=1.0)) * shape_weight
    return l_loc, l_shape, pred_anchors.detach(), valid


def ga_loss(level_outs: List[Dict], batch, head_cfg: HeadConfig,
            assign_cfg, canvas_hw, center_ratio=0.2, ignore_ratio=0.5,
            anchoring_stds=ANCHORING_STDS, target_stds=(1.0, 1.0, 1.0, 1.0),
            loc_weight=1.0, shape_weight=0.2):
    """The GA-Retina loss: location focal + bounded-IoU shape + focal cls
    + smooth-L1 reg on the guided anchors. Returns (total, {'loss_cls',
    'loss_bbox', 'loss_loc', 'loss_shape', 'num_pos'})."""
    num_classes = head_cfg.num_classes
    l_loc, l_shape, guided, valid = ga_loc_shape_losses(
        level_outs, batch, head_cfg, assign_cfg, canvas_hw, center_ratio,
        ignore_ratio, anchoring_stds, shape_weight)
    cls, reg = _flat(level_outs, 'cls', num_classes), \
        _flat(level_outs, 'bbox', 4)

    with torch.no_grad():
        gt_bboxes, gt_labels = batch['gt_bboxes'], batch['gt_labels']
        a = assign_max_iou(guided, valid, gt_bboxes, batch['gt_mask'],
                           pos_iou_thr=assign_cfg.pos_iou_thr,
                           neg_iou_thr=assign_cfg.neg_iou_thr,
                           min_pos_iou=assign_cfg.min_pos_iou,
                           gt_bboxes_ignore=batch.get('gt_bboxes_ignore'),
                           gt_ignore_mask=batch.get('gt_ignore_mask'),
                           ignore_iof_thr=assign_cfg.ignore_iof_thr)
        pf = a.pos_mask.to(torch.float32)
        labels = torch.where(a.pos_mask,
                             torch.gather(gt_labels, 1, a.assigned_gt), 0)
        label_w = (valid & ~a.ignore_mask).to(torch.float32)
        gts = torch.gather(gt_bboxes, 1,
                           a.assigned_gt[..., None].expand(-1, -1, 4))
        deltas = bbox2delta(guided, gts, stds=target_stds) * pf[..., None]
        bbox_w = pf[..., None].expand_as(deltas)
        num_pos = a.pos_mask.sum(dim=1).clamp(min=1)
    avg = global_sum(num_pos.sum().to(torch.float32))
    l_cls = sigmoid_focal_loss(
        cls.reshape(-1, num_classes), labels.reshape(-1),
        label_w.reshape(-1), gamma=head_cfg.focal_gamma,
        alpha=head_cfg.focal_alpha, avg_factor=avg)
    l_bbox = smooth_l1_loss(
        reg.reshape(-1, 4), deltas.reshape(-1, 4), bbox_w.reshape(-1, 4),
        beta=head_cfg.smooth_l1_beta, avg_factor=avg)
    total = l_cls + l_bbox + loc_weight * l_loc + l_shape
    return total, {'loss_cls': l_cls, 'loss_bbox': l_bbox,
                   'loss_loc': l_loc, 'loss_shape': l_shape,
                   'num_pos': avg}


def decode_detections_ga(level_outs, head_cfg: HeadConfig, canvas_hw,
                         img_hw, scale_factor, cfg: TestConfig,
                         anchoring_stds=ANCHORING_STDS,
                         target_stds=(1.0, 1.0, 1.0, 1.0),
                         loc_filter_thr=0.01, squares=None):
    """GA inference: guided anchors from the shape predictions, scores
    zeroed where the location probability is under ``loc_filter_thr``,
    top-``nms_pre`` a level, delta decode, clamp, rescale, NMS with a
    width-3 dummy keypoint. ``squares``: the levels' ``ga_squares`` on the
    outputs' device, made here when None."""
    strides = head_cfg.point_strides
    H, W = canvas_hw
    num_classes = head_cfg.num_classes
    B = level_outs[0]['cls'].shape[1]
    dev = level_outs[0]['cls'].device
    if squares is None:
        squares = [ga_squares(s, head_cfg.octave_base_scale, -(-H // s),
                              -(-W // s), device=dev) for s in strides]
    mlvl_scores, mlvl_boxes = [], []
    for o, sq in zip(level_outs, squares):
        P = sq.shape[0]
        guided = _guided(sq, o['shape'][-1].float().reshape(B, P, 2),
                         anchoring_stds)
        loc = torch.sigmoid(o['loc'][-1].float().reshape(B, P))
        scores = torch.sigmoid(o['cls'][-1].float().reshape(
            B, P, num_classes))
        scores = torch.where((loc >= loc_filter_thr)[..., None], scores,
                             0.0)
        scores, reg, guided = top_k_rows(
            scores, cfg.nms_pre, o['bbox'][-1].float().reshape(B, P, 4),
            guided)
        mlvl_scores.append(scores)
        mlvl_boxes.append(clamp_to_image(
            delta2bbox(guided, reg, stds=target_stds), img_hw))
    return nms_detections(mlvl_scores, mlvl_boxes, scale_factor, cfg,
                          soft_sigma=cfg.soft_nms_sigma,
                          soft_min_score=cfg.soft_nms_min_score)


def ga_rpn_loss(level_outs, batch, head_cfg: HeadConfig, assign_cfg,
                canvas_hw, u, num_samples=256, pos_fraction=0.5,
                pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                target_stds=GA_RPN_TARGET_STDS):
    """The GA-RPN loss (ga_rpn_head.py:35-58): the location and shape terms,
    then binary objectness and class-agnostic smooth-L1 (beta 1/9) on the
    guided anchors, MaxIoU(0.7 / 0.3, min 0.3) targets, 256 sampled at a
    positive fraction of 0.5. u: (B, 4, P) sampler uniforms over the
    levels' positions. Returns (total, logs)."""
    from kgdet_tpu_torch.core.two_stage_loss import bce_loss, \
        sample_pos_neg
    l_loc, l_shape, guided, valid = ga_loc_shape_losses(
        level_outs, batch, head_cfg, assign_cfg, canvas_hw)
    cls, reg = _flat(level_outs, 'cls', 1)[..., 0], \
        _flat(level_outs, 'bbox', 4)
    gts = batch['gt_bboxes'].float()
    with torch.no_grad():
        a = assign_max_iou(guided, valid, gts, batch['gt_mask'],
                           pos_iou_thr, neg_iou_thr, min_pos_iou)
        neg = valid & ~a.pos_mask & ~a.ignore_mask
        pos_sel, neg_sel = sample_pos_neg(u, a.pos_mask, neg, num_samples,
                                          pos_fraction)
        cls_w = (pos_sel | neg_sel).float()
        deltas = bbox2delta(guided, torch.gather(
            gts, 1, a.assigned_gt[..., None].expand(-1, -1, 4)),
            stds=target_stds)
    avg = global_sum(cls_w.sum())
    l_cls = bce_loss(cls, pos_sel.float(), cls_w, avg)
    l_reg = smooth_l1_loss(reg, deltas, pos_sel.float()[..., None],
                           beta=1.0 / 9.0, avg_factor=avg.clamp(min=1.0))
    total = l_cls + l_reg + l_loc + l_shape
    return total, {'loss_rpn_cls': l_cls, 'loss_rpn_bbox': l_reg,
                   'loss_anchor_loc': l_loc, 'loss_anchor_shape': l_shape}


@torch.no_grad()
def ga_rpn_proposals(level_outs, head_cfg: HeadConfig, canvas_hw, img_hw,
                     nms_pre=1000, max_num=1000, nms_thr=0.7,
                     min_bbox_size=0.0, loc_filter_thr=0.01,
                     anchoring_stds=ANCHORING_STDS,
                     target_stds=GA_RPN_TARGET_STDS, squares=None):
    """GA-RPN's fixed-size padded proposals (ga_rpn_head.py
    get_bboxes_single): per level the guided anchors, objectness zeroed
    where the location probability is under ``loc_filter_thr``, the top
    ``nms_pre`` by a stable descending sort, decoded, clamped, boxes not
    wider and taller than ``min_bbox_size`` dropped; then one greedy NMS
    over the levels (models/two_stage.py::proposals_nms). ``squares``: the
    levels' ``ga_squares`` on the outputs' device, made here when None.
    Returns (proposals (B, max_num, 4), scores, valid)."""
    from kgdet_tpu_torch.models.two_stage import proposals_nms
    from kgdet_tpu_torch.ops.nms import NEG_INF
    strides = head_cfg.point_strides
    H, W = canvas_hw
    B = level_outs[0]['cls'].shape[1]
    dev = level_outs[0]['cls'].device
    if squares is None:
        squares = [ga_squares(s, head_cfg.octave_base_scale, -(-H // s),
                              -(-W // s), device=dev) for s in strides]
    lvl_boxes, lvl_scores = [], []
    for o, sq in zip(level_outs, squares):
        P = sq.shape[0]
        guided = _guided(sq, o['shape'][-1].float().reshape(B, P, 2),
                         anchoring_stds)
        loc = torch.sigmoid(o['loc'][-1].float().reshape(B, P))
        scores = torch.sigmoid(o['cls'][-1].float().reshape(B, P))
        scores = torch.where(loc >= loc_filter_thr, scores, 0.0)
        k = min(nms_pre, P)
        top_scores, topk = torch.sort(scores, dim=-1, descending=True,
                                      stable=True)
        top_scores, topk = top_scores[:, :k], topk[:, :k]
        idx = topk[..., None].expand(B, k, 4)
        reg = o['bbox'][-1].float().reshape(B, P, 4)
        boxes = clamp_to_image(delta2bbox(
            guided.gather(1, idx), reg.gather(1, idx), stds=target_stds),
            img_hw)
        ok = (boxes[..., 2] - boxes[..., 0] > min_bbox_size) \
            & (boxes[..., 3] - boxes[..., 1] > min_bbox_size)
        lvl_scores.append(torch.where(ok, top_scores, NEG_INF))
        lvl_boxes.append(boxes)
    return proposals_nms(torch.cat(lvl_boxes, dim=1),
                         torch.cat(lvl_scores, dim=1), nms_thr, max_num)
