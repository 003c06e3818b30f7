"""FCOS target assignment, loss and inference decoding.

Port of kgdet_tpu/core/fcos_loss.py, with the batch dimension written out
where the JAX package uses ``vmap``: points inside a GT box regress its
(l, t, r, b) distances; the pyramid levels split the GTs by regress ranges
of the largest distance; a point inside several takes the GT of least area
(the first on ties, as jnp.argmin); the loss is focal classification,
centerness-weighted IoU regression and BCE centerness. Every term is taken
in f32. In a process group the positive count and the centerness sum that
divide the terms are summed over the processes (``global_sum``), so that
each process's loss is its share of the global batch's.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from kgdet_tpu_torch.config import HeadConfig, TestConfig
from kgdet_tpu_torch.core.anchor_loss import clamp_to_image, \
    nms_detections, top_k_rows
from kgdet_tpu_torch.core.bbox_transforms import distance2bbox
from kgdet_tpu_torch.ops.losses import bce_with_logits, iou_loss, \
    sigmoid_focal_loss
from kgdet_tpu_torch.parallel.dist import global_sum

INF = 1e8
REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512), (512, INF))


def regress_ranges_for(num_levels: int):
    """The first ``num_levels`` ranges, the last one's upper bound opened
    to INF."""
    r = [list(x) for x in REGRESS_RANGES[:num_levels]]
    r[-1][1] = INF
    return [tuple(x) for x in r]


@torch.no_grad()
def fcos_targets(points, ranges, valid, gt_bboxes, gt_labels, gt_mask):
    """Per-point labels and (l, t, r, b) distances, batched.

    points (P, 3) (x, y, stride); ranges (P, 2) each point's regress range;
    valid (B, P); gt_bboxes (B, G, 4), gt_labels (B, G), gt_mask (B, G).
    Returns (labels (B, P) int32, pos (B, P) bool, distances (B, P, 4) and
    centerness (B, P), both zero off the positives)."""
    G = gt_bboxes.shape[1]
    xs = points[:, 0][None, None]                           # (1, 1, P)
    ys = points[:, 1][None, None]
    dists = torch.stack([xs - gt_bboxes[..., 0:1],
                         ys - gt_bboxes[..., 1:2],
                         gt_bboxes[..., 2:3] - xs,
                         gt_bboxes[..., 3:4] - ys], dim=-1)  # (B, G, P, 4)
    inside = dists.amin(dim=-1) > 0
    max_dist = dists.amax(dim=-1)
    in_range = (max_dist >= ranges[:, 0]) & (max_dist <= ranges[:, 1])
    areas = (gt_bboxes[..., 2] - gt_bboxes[..., 0]) \
        * (gt_bboxes[..., 3] - gt_bboxes[..., 1])
    eligible = inside & in_range & gt_mask[..., None] & valid[:, None]
    area_mat = torch.where(eligible, areas[..., None],
                           torch.full_like(max_dist, INF))   # (B, G, P)
    least = area_mat.amin(dim=1)
    gt_ids = torch.arange(G, device=points.device)[:, None]
    assigned = torch.where(area_mat == least[:, None], gt_ids,
                           G).amin(dim=1)                   # first on ties
    pos = least < INF / 2
    labels = torch.where(pos, torch.gather(gt_labels, 1, assigned), 0)
    tgt = torch.gather(dists, 1, assigned[:, None, :, None].expand(
        -1, 1, -1, 4))[:, 0]                                # (B, P, 4)
    lr, tb = tgt[..., [0, 2]], tgt[..., [1, 3]]
    ctr = torch.sqrt((
        (lr.amin(-1) / lr.amax(-1).clamp(min=1e-6))
        * (tb.amin(-1) / tb.amax(-1).clamp(min=1e-6))).clamp(min=0))
    posf = pos.to(tgt.dtype)
    return labels.to(torch.int32), pos, tgt * posf[..., None], ctr * posf


def _level_ranges(level_points):
    rr = regress_ranges_for(len(level_points))
    return torch.cat([
        torch.tensor(rr[i], dtype=torch.float32,
                     device=p.device).expand(p.shape[0], 2)
        for i, p in enumerate(level_points)], dim=0)


def fcos_loss(level_outs: List[Dict], level_points: Sequence, valids,
              batch, head_cfg: HeadConfig):
    """Focal cls + centerness-weighted IoU + BCE centerness over all
    levels. Returns (total, {'loss_cls', 'loss_bbox', 'loss_centerness',
    'num_pos'})."""
    num_classes = head_cfg.num_classes
    points = torch.cat(list(level_points), dim=0)
    valid = torch.cat(list(valids), dim=1)
    labels, pos, tgt_dists, tgt_ctr = fcos_targets(
        points, _level_ranges(level_points), valid, batch['gt_bboxes'],
        batch['gt_labels'], batch['gt_mask'])

    B = labels.shape[0]

    def flat(key, width):
        return torch.cat([o[key][-1].float().reshape(B, -1, width)
                          for o in level_outs], dim=1)
    cls, dist, ctr = flat('cls', num_classes), flat('bbox', 4), \
        flat('centerness', 1)[..., 0]

    posf = pos.to(torch.float32)
    num_pos = global_sum(posf.sum()).clamp(min=1.0)
    l_cls = sigmoid_focal_loss(
        cls.reshape(-1, num_classes), labels.reshape(-1),
        valid.reshape(-1).to(torch.float32), gamma=head_cfg.focal_gamma,
        alpha=head_cfg.focal_alpha, avg_factor=num_pos)

    pts_xy = points[None, :, :2]
    boxes_pred = distance2bbox(pts_xy, dist)
    boxes_tgt = distance2bbox(pts_xy, tgt_dists)
    ctr_w = tgt_ctr * posf
    ctr_sum = global_sum(ctr_w.sum()).clamp(min=1e-6)
    l_bbox = iou_loss(boxes_pred.reshape(-1, 4), boxes_tgt.reshape(-1, 4),
                      ctr_w.reshape(-1), avg_factor=ctr_sum)
    l_ctr = (bce_with_logits(ctr, tgt_ctr) * posf).sum() / num_pos

    total = l_cls + l_bbox + l_ctr
    return total, {'loss_cls': l_cls, 'loss_bbox': l_bbox,
                   'loss_centerness': l_ctr, 'num_pos': num_pos}


def decode_detections_fcos(level_outs, level_points, img_hw, scale_factor,
                           cfg: TestConfig, num_classes: int):
    """Scores times the sigmoid centerness, top-``nms_pre`` a level,
    distance decode, clamp to the resized image, rescale, NMS with a
    width-3 dummy keypoint (soft-NMS at its default sigma and floor, as
    in the JAX decode)."""
    B = level_outs[0]['cls'].shape[1]
    mlvl_scores, mlvl_boxes = [], []
    for outs, pts in zip(level_outs, level_points):
        P = pts.shape[0]
        scores = torch.sigmoid(
            outs['cls'][-1].float().reshape(B, P, num_classes)) \
            * torch.sigmoid(outs['centerness'][-1].float().reshape(B, P, 1))
        scores, dist, xy = top_k_rows(
            scores, cfg.nms_pre, outs['bbox'][-1].float().reshape(B, P, 4),
            pts[None, :, :2].expand(B, P, 2))
        mlvl_scores.append(scores)
        mlvl_boxes.append(clamp_to_image(distance2bbox(xy, dist), img_hw))
    return nms_detections(mlvl_scores, mlvl_boxes, scale_factor, cfg)
