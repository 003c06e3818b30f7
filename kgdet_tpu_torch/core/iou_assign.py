"""MaxIoU assignment as one fixed-shape (G, P) IoU-matrix program.

Port of kgdet_tpu/core/iou_assign.py, with the batch dimension written out
where the JAX package uses ``vmap``: every function takes its arguments with
or without leading batch dimensions. The reference's MaxIoUAssigner
semantics:

  1. each candidate takes its max-IoU GT;
  2. max IoU < neg_thr -> negative, in [neg_thr, pos_thr) -> ignored;
  3. each GT additionally claims every candidate tied at the GT's own best
     IoU when that best >= min_pos_iou, applied in GT order so later GTs
     override earlier ones.

Padded GTs and invalid candidates are masked out of the IoU matrix. Nothing
here carries a gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def _area(b):
    return (b[..., 2] - b[..., 0]).clamp(min=0) \
        * (b[..., 3] - b[..., 1]).clamp(min=0)


def _intersection(a, b):
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0)
    return wh[..., 0] * wh[..., 1]


def iou_xyxy(a, b, eps=1e-6):
    """IoU matrix between (..., G, 4) and (..., P, 4) xyxy boxes (exclusive
    widths) -> (..., G, P)."""
    inter = _intersection(a, b)
    union = _area(a)[..., :, None] + _area(b)[..., None, :] - inter
    return inter / union.clamp(min=eps)


def iof_xyxy(a, b, eps=1e-6):
    """Intersection-over-foreground matrix: inter(a_i, b_j) / area(a_i)."""
    return _intersection(a, b) / _area(a)[..., :, None].clamp(min=eps)


class IoUAssignment(NamedTuple):
    assigned_gt: torch.Tensor   # (..., P) int64 index into G (valid where pos)
    pos_mask: torch.Tensor      # (..., P) bool
    ignore_mask: torch.Tensor   # (..., P) bool: neither positive nor negative
    max_iou: torch.Tensor       # (..., P) float best-GT IoU (-1 for masked)


@torch.no_grad()
def assign_max_iou(candidates, cand_valid, gt_bboxes, gt_mask,
                   pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
                   gt_bboxes_ignore=None, gt_ignore_mask=None,
                   ignore_iof_thr=-1.0):
    """MaxIoUAssigner. candidates (..., P, 4) xyxy; cand_valid (..., P) bool;
    gt_bboxes (..., G, 4); gt_mask (..., G) bool.

    With ignore_iof_thr > 0 and crowd regions (gt_bboxes_ignore (..., Gi, 4)
    and gt_ignore_mask (..., Gi)), candidates whose IoF with any crowd
    region exceeds the threshold become neither positive nor negative.
    """
    G = gt_bboxes.shape[-2]
    overlaps = iou_xyxy(gt_bboxes, candidates)              # (..., G, P)
    eligible = gt_mask[..., :, None] & cand_valid[..., None, :]
    crowd = torch.zeros_like(cand_valid)
    if ignore_iof_thr > 0 and gt_bboxes_ignore is not None:
        iof = iof_xyxy(candidates, gt_bboxes_ignore)        # (..., P, Gi)
        iof = torch.where(gt_ignore_mask[..., None, :], iof,
                          torch.full_like(iof, -1.0))
        crowd = iof.amax(dim=-1) > ignore_iof_thr
        eligible = eligible & ~crowd[..., None, :]
    overlaps = torch.where(eligible, overlaps,
                           torch.full_like(overlaps, -1.0))

    max_iou = overlaps.amax(dim=-2)                         # (..., P)
    gt_ids = torch.arange(G, device=overlaps.device)[:, None]
    # first index on ties, as jnp.argmax: torch.argmax does not promise
    # which of several equal maxima it returns
    argmax_gt = torch.where(overlaps == max_iou[..., None, :], gt_ids,
                            G).amin(dim=-2)
    pos = max_iou >= pos_iou_thr
    ignore = (max_iou >= neg_iou_thr) & (max_iou < pos_iou_thr)

    # step 3: the reference's loop runs in ascending GT order with later GTs
    # overriding, so a candidate goes to the LAST GT that claims it
    gt_best = overlaps.amax(dim=-1)                         # (..., G)
    claims = (overlaps == gt_best[..., None]) \
        & (gt_best[..., None] >= min_pos_iou) & eligible
    last_claim = torch.where(claims, gt_ids, -1).amax(dim=-2)
    claimed = last_claim >= 0

    assigned = torch.where(claimed, last_claim, argmax_gt)
    pos_all = (pos | claimed) & cand_valid
    ignore = (ignore | crowd) & ~pos_all
    return IoUAssignment(assigned, pos_all, ignore, max_iou)
