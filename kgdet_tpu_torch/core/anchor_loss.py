"""Anchor-based head training losses and inference decoding (RetinaNet and
SSD families).

Port of kgdet_tpu/core/anchor_loss.py, with the batch dimension written out
where the JAX package uses ``vmap``. Targets: MaxIoU assignment over the
concatenated multi-level anchor set and delta-encoded regression
(``anchor_targets``); ``retina_loss``: sigmoid focal classification and
smooth-L1 deltas; ``ssd_loss``: softmax cross entropy with per-image 3:1
hard-negative mining and smooth-L1 on std-scaled deltas. Decoding:
per-level top-``nms_pre``, delta decode, clamp to the resized image,
rescale, multiclass NMS; both decodes carry a dummy keypoint of width 3,
as the JAX package's do. Every term is computed in f32. In a process group
the average factors (positive counts) are summed over the processes, as in
core/loss.py.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from kgdet_tpu_torch.config import HeadConfig, TestConfig
from kgdet_tpu_torch.core.bbox_transforms import bbox2delta, delta2bbox
from kgdet_tpu_torch.core.iou_assign import assign_max_iou
from kgdet_tpu_torch.ops.losses import sigmoid_focal_loss, smooth_l1_loss
from kgdet_tpu_torch.ops.nms import multiclass_nms_kp
from kgdet_tpu_torch.parallel.dist import global_sum


@torch.no_grad()
def anchor_targets(anchors, anchor_valid, gt_bboxes, gt_labels, gt_mask,
                   pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
                   gt_bboxes_ignore=None, gt_ignore_mask=None,
                   ignore_iof_thr=-1.0):
    """Batched anchor targets over the concatenated anchor set.

    anchors (P, 4); anchor_valid (B, P); gt_bboxes (B, G, 4), gt_labels
    (B, G), gt_mask (B, G). Returns (labels (B, P) int32, label_weights
    (B, P), deltas (B, P, 4), bbox_weights (B, P, 4), num_pos (B,) int32
    clamped to >= 1). Anchors inside crowd regions (IoF > ignore_iof_thr)
    get label weight 0."""
    a = assign_max_iou(anchors, anchor_valid, gt_bboxes, gt_mask,
                       pos_iou_thr, neg_iou_thr, min_pos_iou,
                       gt_bboxes_ignore=gt_bboxes_ignore,
                       gt_ignore_mask=gt_ignore_mask,
                       ignore_iof_thr=ignore_iof_thr)
    pos = a.pos_mask
    posf = pos.to(torch.float32)
    idx = a.assigned_gt
    labels = torch.where(pos, torch.gather(gt_labels, 1, idx), 0)
    label_weights = (anchor_valid & ~a.ignore_mask).to(torch.float32)
    gts = torch.gather(gt_bboxes, 1, idx[..., None].expand(-1, -1, 4))
    deltas = bbox2delta(anchors, gts) * posf[..., None]
    bbox_weights = posf[..., None].expand_as(deltas)
    num_pos = pos.sum(dim=1).to(torch.int32).clamp(min=1)
    return labels.to(torch.int32), label_weights, deltas, bbox_weights, \
        num_pos


def _targets(anchors_per_level, valids_per_level, batch, assign_cfg):
    return anchor_targets(
        torch.cat(list(anchors_per_level), dim=0),
        torch.cat(list(valids_per_level), dim=1), batch['gt_bboxes'],
        batch['gt_labels'], batch['gt_mask'],
        pos_iou_thr=assign_cfg.pos_iou_thr,
        neg_iou_thr=assign_cfg.neg_iou_thr,
        min_pos_iou=assign_cfg.min_pos_iou,
        gt_bboxes_ignore=batch.get('gt_bboxes_ignore'),
        gt_ignore_mask=batch.get('gt_ignore_mask'),
        ignore_iof_thr=assign_cfg.ignore_iof_thr)


def _flat_outputs(level_outs, width):
    """The last stage of every level's cls / bbox maps, (1, B, H, W, A*n)
    each, as (B, P, n) f32 over the concatenated anchor set."""
    B = level_outs[0]['cls'].shape[1]
    cls = torch.cat([o['cls'][-1].float().reshape(B, -1, width)
                     for o in level_outs], dim=1)
    reg = torch.cat([o['bbox'][-1].float().reshape(B, -1, 4)
                     for o in level_outs], dim=1)
    return cls, reg


def retina_loss(level_outs: List[Dict], anchors_per_level: Sequence,
                valids_per_level: Sequence, batch, head_cfg: HeadConfig,
                assign_cfg):
    """Focal cls + smooth-L1 delta regression over all levels. Returns
    (total, {'loss_cls', 'loss_bbox', 'num_pos'})."""
    num_classes = head_cfg.num_classes
    labels, label_w, deltas, bbox_w, num_pos = _targets(
        anchors_per_level, valids_per_level, batch, assign_cfg)
    avg = global_sum(num_pos.sum().to(torch.float32))
    cls, reg = _flat_outputs(level_outs, num_classes)
    l_cls = sigmoid_focal_loss(
        cls.reshape(-1, num_classes), labels.reshape(-1),
        label_w.reshape(-1), gamma=head_cfg.focal_gamma,
        alpha=head_cfg.focal_alpha, avg_factor=avg)
    l_bbox = smooth_l1_loss(
        reg.reshape(-1, 4), deltas.reshape(-1, 4), bbox_w.reshape(-1, 4),
        beta=head_cfg.smooth_l1_beta, avg_factor=avg)
    return l_cls + l_bbox, {'loss_cls': l_cls, 'loss_bbox': l_bbox,
                            'num_pos': avg}


def hard_negatives(ce, neg, num_pos_img, neg_pos_ratio):
    """(B, P) mask of each image's ``neg_pos_ratio * num_pos`` negatives
    of highest cross entropy: a rank-against-count compare over a
    descending sort, the order of ties that of jnp.argsort (stable, lower
    index first)."""
    neg_ce = torch.where(neg, ce, torch.full_like(ce, -float('inf')))
    order = torch.sort(-neg_ce, dim=1, stable=True)[1]
    P = ce.shape[1]
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(P, device=ce.device).expand_as(order))
    return neg & (rank < (neg_pos_ratio * num_pos_img)[:, None])


def ssd_loss(level_outs, anchors_per_level, valids_per_level, batch,
             head_cfg: HeadConfig, assign_cfg, neg_pos_ratio: int = 3,
             target_stds=(0.1, 0.1, 0.2, 0.2)):
    """SSD MultiBox loss: softmax CE with hard-negative mining (the top
    ``neg_pos_ratio * num_pos`` negatives of each image by their CE) and
    smooth-L1 on the std-scaled deltas of the positives; both terms divided
    by the batch's positive count. Returns (total, {'loss_cls',
    'loss_bbox', 'num_pos'})."""
    C1 = head_cfg.num_classes + 1
    labels, label_w, deltas, bbox_w, _ = _targets(
        anchors_per_level, valids_per_level, batch, assign_cfg)
    cls, reg = _flat_outputs(level_outs, C1)
    logp = F.log_softmax(cls, dim=-1)
    ce = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    ce = ce * label_w                                       # (B, P)

    pos = (labels > 0) & (label_w > 0)
    neg = (labels == 0) & (label_w > 0)
    num_pos_img = pos.sum(dim=1)                            # (B,)
    sel_neg = hard_negatives(ce.detach(), neg, num_pos_img, neg_pos_ratio)
    total_pos = global_sum(num_pos_img.sum().to(torch.float32)).clamp(min=1.0)
    l_cls = (ce * (pos | sel_neg)).sum() / total_pos

    # smooth-L1 on std-scaled delta targets (bbox_w marks the positives)
    deltas_std = deltas / deltas.new_tensor(target_stds)
    l_bbox = smooth_l1_loss(reg, deltas_std, bbox_w, beta=1.0,
                            avg_factor=total_pos)
    return l_cls + l_bbox, {'loss_cls': l_cls, 'loss_bbox': l_bbox,
                            'num_pos': total_pos}


def top_k_rows(scores, nms_pre, *tensors):
    """The top-``nms_pre`` rows (dim 1) by each row's max score of
    ``scores`` (B, P, C) and of every (B, P, n) tensor, when 0 < nms_pre <
    P; the stable descending sort keeps the lower index first on ties, as
    jax.lax.top_k does."""
    P = scores.shape[1]
    if not 0 < nms_pre < P:
        return (scores, *tensors)
    topk = torch.sort(scores.amax(-1), dim=-1, descending=True,
                      stable=True)[1][:, :nms_pre]
    return tuple(t.gather(1, topk[..., None].expand(-1, -1, t.shape[-1]))
                 for t in (scores, *tensors))


def clamp_to_image(boxes, img_hw):
    """xyxy boxes (B, N, 4) clamped to [0, w] x [0, h] of each resized
    image."""
    w = img_hw[:, 1].float()[:, None]
    h = img_hw[:, 0].float()[:, None]
    return torch.stack([
        torch.minimum(boxes[..., 0].clamp(min=0), w),
        torch.minimum(boxes[..., 1].clamp(min=0), h),
        torch.minimum(boxes[..., 2].clamp(min=0), w),
        torch.minimum(boxes[..., 3].clamp(min=0), h)], dim=-1)


def nms_detections(mlvl_scores, mlvl_boxes, scale_factor, cfg: TestConfig,
                   **nms_kw):
    """The levels' scores and boxes concatenated, rescaled to the original
    images, then multiclass NMS with a width-3 dummy keypoint: the padded
    dict of the decodes."""
    scores = torch.cat(mlvl_scores, dim=1)
    boxes = torch.cat(mlvl_boxes, dim=1) \
        / scale_factor.float()[:, None, None]
    B = boxes.shape[0]
    det_bboxes, det_labels, det_kpts, valid = multiclass_nms_kp(
        boxes, scores, boxes.new_zeros((B, boxes.shape[1], 3)),
        cfg.score_thr, cfg.nms_iou_thr, max_per_class=cfg.max_per_class,
        max_per_img=cfg.max_per_img, nms_type=cfg.nms_type, **nms_kw)
    return {'det_bboxes': det_bboxes, 'det_labels': det_labels,
            'det_kpts': det_kpts, 'valid': valid}


def _decode(level_outs, anchors_per_level, img_hw, scale_factor,
            cfg: TestConfig, scores_of, stds):
    """Per level: scores_of(cls logits (B, P, ·)) -> (B, P, C) scores,
    top-``nms_pre`` by max score, delta decode, clamp to the resized
    image; then rescale and multiclass NMS with a width-3 dummy keypoint."""
    B = level_outs[0]['cls'].shape[1]
    mlvl_scores, mlvl_bboxes = [], []
    for outs, anchors in zip(level_outs, anchors_per_level):
        P = anchors.shape[0]
        scores, reg, anc = top_k_rows(
            scores_of(outs['cls'][-1].float().reshape(B, P, -1)),
            cfg.nms_pre, outs['bbox'][-1].float().reshape(B, P, 4),
            anchors[None].expand(B, P, 4))
        mlvl_scores.append(scores)
        mlvl_bboxes.append(clamp_to_image(delta2bbox(anc, reg, stds=stds),
                                          img_hw))
    return nms_detections(mlvl_scores, mlvl_bboxes, scale_factor, cfg,
                          soft_sigma=cfg.soft_nms_sigma,
                          soft_min_score=cfg.soft_nms_min_score)


def decode_detections_anchor(level_outs, anchors_per_level, img_hw,
                             scale_factor, cfg: TestConfig,
                             num_classes: int):
    """RetinaNet inference: sigmoid scores, top-k, delta decode, clamp,
    rescale, NMS. Returns det_bboxes (B, M, 5), det_labels (B, M),
    det_kpts (B, M, 3) zeros, valid (B, M)."""
    return _decode(level_outs, anchors_per_level, img_hw, scale_factor, cfg,
                   torch.sigmoid, (1., 1., 1., 1.))


def decode_detections_ssd(level_outs, anchors_per_level, img_hw,
                          scale_factor, cfg: TestConfig, num_classes: int,
                          target_stds=(0.1, 0.1, 0.2, 0.2)):
    """SSD inference: softmax scores with the background column dropped,
    std-scaled delta decode, clamp, rescale, NMS; the same padded dict as
    ``decode_detections_anchor``."""
    return _decode(level_outs, anchors_per_level, img_hw, scale_factor, cfg,
                   lambda logits: F.softmax(logits, dim=-1)[..., 1:],
                   target_stds)
