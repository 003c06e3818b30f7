"""VOC-style mAP and proposal recall (pure NumPy).

Parity reference: the reference's mmdet/core/evaluation/
mean_ap.py (tpfp_default, average_precision, eval_map) and recall.py
(eval_recalls). Used for datasets scored with the PASCAL protocol instead of
COCO (the reference's VOC/WIDER datasets).

The port's own copy of kgdet_tpu/eval/mean_ap.py, NumPy and the stdlib only.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def _iou(boxes1, boxes2):
    if boxes1.size == 0 or boxes2.size == 0:
        return np.zeros((boxes1.shape[0], boxes2.shape[0]))
    tl = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    br = np.minimum(boxes1[:, None, 2:4], boxes2[None, :, 2:4])
    wh = np.clip(br - tl + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (boxes1[:, 2] - boxes1[:, 0] + 1) * (boxes1[:, 3] - boxes1[:, 1] + 1)
    a2 = (boxes2[:, 2] - boxes2[:, 0] + 1) * (boxes2[:, 3] - boxes2[:, 1] + 1)
    return inter / np.maximum(a1[:, None] + a2[None] - inter, 1e-10)


def tpfp_default(dets, gts, gts_ignore=None, iou_thr=0.5):
    """Per-image TP/FP flags for one class (score-ordered greedy matching)."""
    dets = np.asarray(dets, np.float64).reshape(-1, 5)
    gts = np.asarray(gts, np.float64).reshape(-1, 4)
    n_det, n_gt = dets.shape[0], gts.shape[0]
    tp = np.zeros(n_det)
    fp = np.zeros(n_det)
    if n_gt == 0:
        fp[:] = 1
        return tp, fp
    ious = _iou(dets[:, :4], gts)
    order = np.argsort(-dets[:, 4], kind='mergesort')
    covered = np.zeros(n_gt, bool)
    for i in order:
        j = int(np.argmax(ious[i]))
        if ious[i, j] >= iou_thr and not covered[j]:
            covered[j] = True
            tp[i] = 1
        else:
            fp[i] = 1
    return tp, fp


def average_precision(recalls, precisions, mode='area'):
    """AP from a recall/precision curve ('area' or '11points')."""
    recalls = np.asarray(recalls)
    precisions = np.asarray(precisions)
    if mode == 'area':
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(mpre.size - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    ap = 0.0
    for t in np.arange(0, 1.01, 0.1):
        prec = precisions[recalls >= t]
        ap += (prec.max() if prec.size else 0.0) / 11
    return float(ap)


def eval_map(det_results: List[List[np.ndarray]],
             gt_bboxes: List[np.ndarray], gt_labels: List[np.ndarray],
             iou_thr=0.5, mode='area'):
    """VOC mAP over per-image, per-class detections.

    det_results[i][c]: (N, 5) dets of class c (0-based) in image i;
    gt_labels: 1-based like the datasets. Returns (mAP, per-class list).
    """
    num_classes = len(det_results[0])
    aps = []
    per_class = []
    for c in range(num_classes):
        tps, fps, scores = [], [], []
        n_gt = 0
        for dets_img, boxes, labels in zip(det_results, gt_bboxes, gt_labels):
            gts_c = np.asarray(boxes).reshape(-1, 4)[
                np.asarray(labels).reshape(-1) == c + 1]
            n_gt += len(gts_c)
            d = np.asarray(dets_img[c], np.float64).reshape(-1, 5)
            tp, fp = tpfp_default(d, gts_c, iou_thr=iou_thr)
            tps.append(tp)
            fps.append(fp)
            scores.append(d[:, 4])
        scores = np.concatenate(scores)
        order = np.argsort(-scores, kind='mergesort')
        tp = np.cumsum(np.concatenate(tps)[order])
        fp = np.cumsum(np.concatenate(fps)[order])
        if n_gt == 0 or scores.size == 0:
            per_class.append({'ap': 0.0, 'num_gts': n_gt,
                              'num_dets': int(scores.size)})
            if n_gt > 0:
                aps.append(0.0)
            continue
        recalls = tp / n_gt
        precisions = tp / np.maximum(tp + fp, 1e-10)
        ap = average_precision(recalls, precisions, mode)
        aps.append(ap)
        per_class.append({'ap': ap, 'num_gts': n_gt,
                          'num_dets': int(scores.size),
                          'recall': float(recalls[-1]) if tp.size else 0.0})
    mean_ap = float(np.mean(aps)) if aps else 0.0
    return mean_ap, per_class


def eval_recalls(gts: List[np.ndarray], proposals: List[np.ndarray],
                 proposal_nums: Sequence[int] = (100, 300, 1000),
                 iou_thrs: Sequence[float] = (0.5,)):
    """Proposal recall matrix (len(proposal_nums), len(iou_thrs))."""
    recalls = np.zeros((len(proposal_nums), len(iou_thrs)))
    total_gt = sum(len(g) for g in gts)
    if total_gt == 0:
        return recalls
    for pi, num in enumerate(proposal_nums):
        for ti, thr in enumerate(iou_thrs):
            hit = 0
            for g, p in zip(gts, proposals):
                g = np.asarray(g, np.float64).reshape(-1, 4)
                p = np.asarray(p, np.float64).reshape(-1, p.shape[-1]
                                                      if p.size else 4)
                if p.shape[-1] == 5:
                    order = np.argsort(-p[:, 4], kind='mergesort')
                    p = p[order]
                p = p[:num, :4]
                if g.size == 0:
                    continue
                if p.size == 0:
                    continue
                ious = _iou(g, p)
                hit += int((ious.max(axis=1) >= thr).sum())
            recalls[pi, ti] = hit / total_gt
    return recalls


def eval_voc_results(results, dataset, iou_thr=0.5, mode='area'):
    """VOC-protocol mAP for {img_id: (dets (N, 5), labels0 (N,), ...)}
    result dicts over an XML-style dataset (parity: the reference's
    mean_ap-based VOC evaluation path; mode='11points' gives the VOC07
    metric). Ignore regions are excluded from the GT sets, matching
    tpfp_default's handling of absent GTs.
    """
    num_classes = len(dataset.class_names)
    det_results, gt_bboxes, gt_labels = [], [], []
    for rec in dataset.records:
        dets, labels = results[rec.img_id][:2]
        det_results.append([np.asarray(dets).reshape(-1, 5)[
            np.asarray(labels).reshape(-1) == c]
            for c in range(num_classes)])
        b, l, _, _ignore = dataset.parse_annotations(rec.img_id)
        gt_bboxes.append(b)
        gt_labels.append(l)
    return eval_map(det_results, gt_bboxes, gt_labels, iou_thr=iou_thr,
                    mode=mode)
