"""Box coordinate transforms (delta coding, RoI packing, distance coding).

Port of kgdet_tpu/core/bbox_transforms.py: batched tensor expressions
(``bbox2delta``, ``delta2bbox``, ``distance2bbox``, ``bbox2roi``) and the
host-side NumPy helpers of test-time augmentation and result formatting
(``bbox_mapping``, ``bbox_mapping_back``, ``bbox2result``). Legacy mmdet v1
widths (x2 - x1 + 1).
"""
from __future__ import annotations

import numpy as np
import torch


def bbox2delta(proposals, gt, means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.)):
    """Encode gt boxes as (dx, dy, dw, dh) deltas wrt proposals (xyxy)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    return (deltas - means) / stds


def _clip_to(x1, y1, x2, y2, max_shape):
    if max_shape is None:
        return x1, y1, x2, y2
    h, w = max_shape[0] - 1, max_shape[1] - 1
    return (x1.clamp(0, w), y1.clamp(0, h), x2.clamp(0, w), y2.clamp(0, h))


def delta2bbox(rois, deltas, means=(0., 0., 0., 0.), stds=(1., 1., 1., 1.),
               max_shape=None, wh_ratio_clip=16 / 1000):
    """Decode (dx, dy, dw, dh) deltas into xyxy boxes (legacy +1 widths);
    log-scale deltas clipped to |log(wh_ratio_clip)|, boxes clipped to
    ``max_shape`` (h, w) where given."""
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    d = deltas * stds + means
    dx, dy, dw, dh = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    max_ratio = float(np.abs(np.log(wh_ratio_clip)))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px = (rois[..., 0] + rois[..., 2]) * 0.5
    py = (rois[..., 1] + rois[..., 3]) * 0.5
    pw = rois[..., 2] - rois[..., 0] + 1.0
    ph = rois[..., 3] - rois[..., 1] + 1.0
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    boxes = _clip_to(gx - gw * 0.5 + 0.5, gy - gh * 0.5 + 0.5,
                     gx + gw * 0.5 - 0.5, gy + gh * 0.5 - 0.5, max_shape)
    return torch.stack(boxes, dim=-1)


def distance2bbox(points, distance, max_shape=None):
    """(left, top, right, bottom) distances from points -> xyxy boxes."""
    boxes = _clip_to(points[..., 0] - distance[..., 0],
                     points[..., 1] - distance[..., 1],
                     points[..., 0] + distance[..., 2],
                     points[..., 1] + distance[..., 3], max_shape)
    return torch.stack(boxes, dim=-1)


def bbox2roi(bbox_list):
    """Per-image box tensors -> packed (R, 5) rois with batch indices."""
    return torch.cat([torch.cat([bboxes.new_full((bboxes.shape[0], 1),
                                                 float(img_id)),
                                 bboxes[:, :4]], dim=-1)
                      for img_id, bboxes in enumerate(bbox_list)], dim=0)


def bbox_mapping(bboxes, img_shape, scale_factor, flip):
    """Original-image boxes -> augmented-image coordinates (host NumPy)."""
    from kgdet_tpu_torch.data.transforms import flip_bboxes
    out = np.asarray(bboxes) * scale_factor
    if flip:
        out = flip_bboxes(out, img_shape[1])
    return out


def bbox_mapping_back(bboxes, img_shape, scale_factor, flip):
    """Augmented-image boxes -> original-image coordinates (host NumPy)."""
    from kgdet_tpu_torch.data.transforms import flip_bboxes
    out = np.asarray(bboxes)
    if flip:
        out = flip_bboxes(out, img_shape[1])
    return out / scale_factor


def bbox2result(bboxes, labels, num_classes):
    """(N, 5) dets + (N,) 0-based labels -> per-class NumPy list."""
    if torch.is_tensor(bboxes):
        bboxes = bboxes.detach().cpu().numpy()
    if torch.is_tensor(labels):
        labels = labels.detach().cpu().numpy()
    bboxes, labels = np.asarray(bboxes), np.asarray(labels)
    return [bboxes[labels == c] for c in range(num_classes)]

