"""Proposal recall (AR@N) evaluation, pure NumPy.

Parity surface: the reference's mmdet/core/evaluation/
recall.py:7-100 — per-image greedy GT<->proposal matching on the top-N
proposals (each round pairs the globally best remaining (gt, box) IoU and
retires both), recall = fraction of GTs whose matched IoU >= thr, pooled
over the dataset. Used by the standalone RPN detector's eval
(reference detectors/rpn.py + tools/test.py 'proposal_fast').

The port's own copy of kgdet_tpu/eval/recall.py, NumPy and the stdlib only.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def bbox_overlaps_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, M) IoU matrix between xyxy boxes, legacy inclusive (+1)
    convention — the reference recall protocol's bbox_overlaps
    (core/evaluation/bbox_overlaps.py) and this repo's eval/mean_ap.py
    both use (x2 - x1 + 1) areas; AR@N must match that to be comparable."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(br - tl + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    union = area_a[:, None] + area_b[None, :] - inter
    return (inter / np.maximum(union, 1e-10)).astype(np.float32)


def _greedy_gt_ious(ious: np.ndarray) -> np.ndarray:
    """Per-GT matched IoU under the reference's greedy pairing
    (recall.py:21-28): repeatedly take the (gt, box) pair with the highest
    IoU among remaining rows/columns."""
    ious = ious.copy()
    G = ious.shape[0]
    out = np.full((G,), -1.0, np.float32)
    for j in range(G):
        if ious.size == 0:
            break
        gt_best = ious.argmax(axis=1)
        max_ious = ious[np.arange(G), gt_best]
        g = max_ious.argmax()
        out[j] = max_ious[g]               # pooled slot, reference order
        ious[g, :] = -1
        ious[:, gt_best[g]] = -1
    return out


def eval_recalls(gts: Sequence[np.ndarray], proposals: Sequence[np.ndarray],
                 proposal_nums=(100, 300, 1000), iou_thrs=(0.5,)):
    """recalls[k, t] over top-N cuts and IoU thresholds.

    gts: per-image (G, 4); proposals: per-image (P, 4) or (P, 5) — when a
    score column is present, proposals are sorted by it descending first
    (reference eval_recalls:88-95).
    """
    proposal_nums = np.asarray(proposal_nums, np.int64)
    iou_thrs = np.asarray(iou_thrs, np.float64)
    total_gts = int(sum(g.shape[0] for g in gts))
    pooled = np.zeros((proposal_nums.size, max(total_gts, 1)), np.float32)
    col = 0
    for g, p in zip(gts, proposals):
        g = np.asarray(g, np.float32).reshape(-1, 4)
        p = np.asarray(p, np.float32)
        if p.ndim == 2 and p.shape[1] == 5:
            p = p[np.argsort(-p[:, 4])][:, :4]
        if g.shape[0] == 0:
            continue
        ious = bbox_overlaps_np(g, p.reshape(-1, 4))
        for k, n in enumerate(proposal_nums):
            pooled[k, col:col + g.shape[0]] = _greedy_gt_ious(ious[:, :n])
        col += g.shape[0]
    recalls = np.zeros((proposal_nums.size, iou_thrs.size), np.float64)
    if total_gts:
        for t, thr in enumerate(iou_thrs):
            recalls[:, t] = (pooled >= thr).sum(axis=1) / total_gts
    return recalls


def eval_proposal_recall(results: Dict[int, tuple], dataset,
                         proposal_nums=(100, 300, 1000),
                         iou_thrs=(0.5,), verbose=True):
    """AR@N for per-image (dets, labels, kpts) result tuples vs dataset GTs.

    Returns {'AR@N': recall_at_iou0} stats (plus the full matrix)."""
    gts, props = [], []
    for img_id in sorted(results.keys()):
        anns = [a for a in dataset.coco.img_to_anns.get(img_id, [])
                if not a.get('iscrowd', 0)]
        g = np.asarray([a['bbox'] for a in anns], np.float32).reshape(-1, 4)
        if g.size:
            # COCO xywh -> xyxy with inclusive corners (x1+w-1), matching
            # bbox_overlaps_np's legacy (+1) convention and the reference's
            # coco.py:128 / this repo's dataset.py GT parsing
            g = np.concatenate([g[:, :2], g[:, :2] + g[:, 2:4] - 1], axis=1)
        gts.append(g)
        props.append(np.asarray(results[img_id][0], np.float32))
    recalls = eval_recalls(gts, props, proposal_nums, iou_thrs)
    stats = {f'AR@{int(n)}': float(recalls[k, 0])
             for k, n in enumerate(proposal_nums)}
    stats['recalls'] = recalls
    if verbose:
        print(' '.join(f'AR@{int(n)}={recalls[k, 0]:.4f}'
                       for k, n in enumerate(proposal_nums)))
    return stats
