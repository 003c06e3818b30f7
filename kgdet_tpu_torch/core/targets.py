"""Target assignment and target building, as fixed-shape batched tensor ops.

Port of kgdet_tpu/core/targets.py (``PointTargets``,
``assign_points_single``, ``point_targets`` and, for the refine stage of
the serial / parallel heads, ``max_iou_targets``), with the batch dimension
written out where the JAX package uses ``vmap``. The point assignment is a
(B, G, P) distance-matrix program:

- each GT is mapped to its pyramid level by log2 scale;
- a GT's candidates are the ``pos_num`` closest (center distance normalized
  by GT w/h) valid grid points of its level (top-k over the masked row);
- each point takes the nearest of the GTs that selected it (ties -> lower
  GT index), which reproduces the reference's sequential keep-if-closer
  loop.

Padded GTs and invalid grid points are masked with INF distances. Nothing
here carries a gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INF = 1e9
# deterministic tie-break between equidistant grid points inside one GT's
# top-k: a ramp over the point index, the same for every GT
TIE_EPS = 1e-6


class PointTargets(NamedTuple):
    labels: torch.Tensor          # (B, P) int32, 0 = bg/pad
    label_weights: torch.Tensor   # (B, P) float, 0 on invalid grid points
    bbox_gt: torch.Tensor         # (B, P, 4)
    bbox_weights: torch.Tensor    # (B, P, 4)
    kpt_gt: torch.Tensor          # (B, P, K*2) interleaved (x, y)
    kpt_weights: torch.Tensor     # (B, P, K*2)
    num_pos: torch.Tensor         # (B,) int32 (clamped to >= 1)


def assign_points(points, point_valid, gt_bboxes, gt_mask, scale, pos_num):
    """Batched PointAssigner.

    points: (P, 3) (x, y, stride); point_valid: (B, P) bool;
    gt_bboxes: (B, G, 4) xyxy; gt_mask: (B, G) bool.
    Returns (assigned_gt (B, P) int64 index into G, pos_mask (B, P) bool).
    """
    P = points.shape[0]
    pts_xy = points[:, :2]
    pts_lvl = torch.log2(points[:, 2]).to(torch.int32)
    lvl_min, lvl_max = pts_lvl.min(), pts_lvl.max()

    ctr = (gt_bboxes[..., :2] + gt_bboxes[..., 2:]) / 2
    wh = (gt_bboxes[..., 2:] - gt_bboxes[..., :2]).clamp(min=1e-6)
    # truncation toward zero (the reference's .int()), not floor
    gt_lvl = torch.trunc(
        (torch.log2(wh[..., 0] / scale) + torch.log2(wh[..., 1] / scale)) / 2
    ).to(torch.int32)
    gt_lvl = torch.minimum(torch.maximum(gt_lvl, lvl_min), lvl_max)

    diff = (pts_xy[None, None] - ctr[:, :, None]) / wh[:, :, None]
    dist = torch.linalg.vector_norm(diff, dim=-1)           # (B, G, P)
    eligible = (pts_lvl[None, None, :] == gt_lvl[..., None]) \
        & point_valid[:, None, :] & gt_mask[..., None]
    dist = torch.where(eligible, dist, torch.full_like(dist, INF))
    dist = dist + torch.arange(P, device=dist.device) * TIE_EPS

    # per-GT top-pos_num nearest points -> candidate threshold
    kth = torch.topk(dist, min(pos_num, P), dim=-1, largest=False) \
        .values[..., -1]                                    # (B, G)
    candidate = (dist <= kth[..., None]) & (dist < INF / 2)

    per_point = torch.where(candidate, dist, torch.full_like(dist, INF))
    # min over G with the first index on ties, as jnp.argmin: torch.min
    # along a dim does not promise which of several equal minima it returns
    min_dist = per_point.amin(dim=1)                        # (B, P)
    G = per_point.shape[1]
    is_min = per_point == min_dist[:, None, :]
    order = torch.arange(G, device=dist.device)[None, :, None]
    assigned = torch.where(is_min, order, G).amin(dim=1)
    return assigned, min_dist < INF / 2


def assign_points_single(points, point_valid, gt_bboxes, gt_mask, scale,
                         pos_num):
    """PointAssigner for one image: (P,) valid, (G, 4) boxes, (G,) mask ->
    (assigned_gt (P,), pos_mask (P,))."""
    assigned, pos = assign_points(points, point_valid[None], gt_bboxes[None],
                                  gt_mask[None], scale, pos_num)
    return assigned[0], pos[0]


def _targets_from_assignment(assigned, pos, ignore, valid, bboxes, labels,
                             kpts):
    """Scatter GT boxes/labels/keypoints onto assigned grid slots, batched:
    assigned/pos/ignore/valid (B, P); bboxes (B, G, 4); labels (B, G);
    kpts (B, G, K, 3)."""
    B, P = assigned.shape
    K = kpts.shape[2]
    posf = pos.to(torch.float32)

    def take(x):                  # (B, G, ...) -> (B, P, ...)
        idx = assigned.reshape(B, P, *([1] * (x.dim() - 2))) \
            .expand(B, P, *x.shape[2:])
        return torch.gather(x, 1, idx)

    labels_out = torch.where(pos, take(labels), 0)
    label_weights = (valid & ~ignore).to(torch.float32)
    bbox_gt = take(bboxes) * posf[..., None]
    bbox_weights = posf[..., None].expand_as(bbox_gt)
    kp = take(kpts)                                         # (B, P, K, 3)
    kpt_gt = (kp[..., :2] * posf[..., None, None]).reshape(B, P, K * 2)
    vis = (kp[..., 2] != 0).to(torch.float32) * posf[..., None]
    kpt_weights = vis.repeat_interleave(2, dim=-1)          # (B, P, K*2)
    num_pos = pos.sum(dim=1).to(torch.int32).clamp(min=1)
    return PointTargets(labels_out.to(torch.int32), label_weights, bbox_gt,
                        bbox_weights, kpt_gt, kpt_weights, num_pos)


@torch.no_grad()
def point_targets(points, point_valid, gt_bboxes, gt_labels, gt_kpts,
                  gt_mask, scale=4, pos_num=25):
    """Batched cls/bbox/keypoint targets (parity: point_target_kp).

    points: (P, 3); point_valid: (B, P); gt_bboxes: (B, G, 4);
    gt_labels: (B, G) (1-based, 0 = pad); gt_kpts: (B, G, K, 3);
    gt_mask: (B, G).
    """
    assigned, pos = assign_points(points, point_valid, gt_bboxes, gt_mask,
                                  scale, pos_num)
    return _targets_from_assignment(assigned, pos, torch.zeros_like(pos),
                                    point_valid, gt_bboxes, gt_labels,
                                    gt_kpts)


@torch.no_grad()
def max_iou_targets(candidates, cand_valid, gt_bboxes, gt_labels, gt_kpts,
                    gt_mask, pos_iou_thr=0.5, neg_iou_thr=0.4,
                    min_pos_iou=0.0, gt_bboxes_ignore=None,
                    gt_ignore_mask=None, ignore_iof_thr=-1.0):
    """Batched refine-stage targets by MaxIoU assignment over candidate
    boxes: candidates (B, P, 4) decoded init boxes, cand_valid (B, P), the
    other arguments as ``point_targets``; optional crowd regions
    gt_bboxes_ignore (B, Gi, 4) with gt_ignore_mask (B, Gi), whose
    candidates (IoF above ignore_iof_thr) get label weight 0."""
    from kgdet_tpu_torch.core.iou_assign import assign_max_iou
    a = assign_max_iou(candidates, cand_valid, gt_bboxes, gt_mask,
                       pos_iou_thr, neg_iou_thr, min_pos_iou,
                       gt_bboxes_ignore=gt_bboxes_ignore,
                       gt_ignore_mask=gt_ignore_mask,
                       ignore_iof_thr=ignore_iof_thr)
    return _targets_from_assignment(a.assigned_gt, a.pos_mask, a.ignore_mask,
                                    cand_valid, gt_bboxes, gt_labels,
                                    gt_kpts)
