"""Detection losses as plain tensor expressions, in the logits' dtype (the
training loss hands them f32).

Port of kgdet_tpu/ops/losses.py: ``sigmoid_focal_loss`` and
``smooth_l1_loss`` (the point and anchor families), ``iou_loss`` and
``giou_loss`` (FCOS), ``bounded_iou_loss`` (GA-Retina's shape branch), and
``cross_entropy_loss``, ``balanced_l1_loss``, ``ghm_c_loss`` and
``mse_loss``, which no module of either package calls yet. The same
weighting and avg_factor semantics throughout (sum(loss * weight) /
avg_factor, or the plain mean without one; ``bounded_iou_loss`` and
``ghm_c_loss`` keep their own, as in the JAX module).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _weighted(loss, weights, avg_factor):
    """sum(loss * weights) / avg_factor, or the plain mean without one."""
    if weights is not None:
        loss = loss * weights
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / avg_factor


def bce_with_logits(logits, target):
    return logits.clamp(min=0) - logits * target + torch.log1p(
        torch.exp(-logits.abs()))


def _one_hot_fg(labels, num_classes, dtype):
    """(N, C) one-hot of 1-based labels, all zero for background (0)."""
    return F.one_hot((labels.long() - 1).clamp(min=0), num_classes) \
        .to(dtype) * (labels > 0)[..., None].to(dtype)


def sigmoid_focal_loss(logits, labels, weights=None, gamma=2.0, alpha=0.25,
                       avg_factor=None):
    """Sigmoid focal loss over (N, C) logits with integer labels.

    labels: (N,) int, 0 = background, 1..C = positive class (1-based).
    weights: (N,) per-sample weight (broadcast over classes)."""
    target = _one_hot_fg(labels, logits.shape[-1], logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1 - p) * target + p * (1 - target)
    focal_weight = (alpha * target + (1 - alpha) * (1 - target)) * pt ** gamma
    loss = bce_with_logits(logits, target) * focal_weight
    return _weighted(loss, None if weights is None else weights[..., None],
                     avg_factor)


def smooth_l1_loss(pred, target, weights=None, beta=1.0, avg_factor=None):
    """Elementwise smooth-L1 with optional per-element weights and
    avg_factor."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)
    return _weighted(loss, weights, avg_factor)


def cross_entropy_loss(logits, labels, weights=None, avg_factor=None):
    """Softmax cross entropy over (N, C+1) logits with 0-based integer
    labels."""
    logp = F.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _weighted(loss, weights, avg_factor)


def balanced_l1_loss(pred, target, weights=None, beta=1.0, alpha=0.5,
                     gamma=1.5, avg_factor=None):
    """Balanced L1 (Libra R-CNN)."""
    diff = (pred - target).abs()
    b = math.e ** (gamma / alpha) - 1
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1) * torch.log1p(b * diff / beta)
        - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return _weighted(loss, weights, avg_factor)


def _overlap(pred, target):
    """Intersection and the two areas of xyxy boxes (exclusive widths)."""
    tl = torch.maximum(pred[..., :2], target[..., :2])
    br = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (br - tl).clamp(min=0)
    area_p = (pred[..., 2] - pred[..., 0]).clamp(min=0) \
        * (pred[..., 3] - pred[..., 1]).clamp(min=0)
    area_t = (target[..., 2] - target[..., 0]).clamp(min=0) \
        * (target[..., 3] - target[..., 1]).clamp(min=0)
    return wh[..., 0] * wh[..., 1], area_p, area_t


def iou_loss(pred, target, weights=None, eps=1e-6, avg_factor=None):
    """-log(IoU) between xyxy boxes."""
    inter, area_p, area_t = _overlap(pred, target)
    iou = inter / (area_p + area_t - inter).clamp(min=eps)
    return _weighted(-torch.log(iou.clamp(min=eps)), weights, avg_factor)


def giou_loss(pred, target, weights=None, eps=1e-6, avg_factor=None):
    """1 - GIoU between xyxy boxes."""
    inter, area_p, area_t = _overlap(pred, target)
    union = (area_p + area_t - inter).clamp(min=eps)
    iou = inter / union
    etl = torch.minimum(pred[..., :2], target[..., :2])
    ebr = torch.maximum(pred[..., 2:], target[..., 2:])
    ewh = (ebr - etl).clamp(min=0)
    enclose = (ewh[..., 0] * ewh[..., 1]).clamp(min=eps)
    giou = iou - (enclose - union) / enclose
    return _weighted(1 - giou, weights, avg_factor)


def ghm_c_loss(logits, labels, weights=None, bins=10, momentum=0.0,
               avg_factor=None):
    """Gradient-harmonized classification loss, the single-pass form of
    the JAX package (no moving average: ``momentum`` is not read). Each
    element is weighted by total / (bins * the count of its gradient-norm
    bin)."""
    target = _one_hot_fg(labels, logits.shape[-1], logits.dtype)
    valid = weights[..., None] > 0 if weights is not None \
        else torch.ones_like(target, dtype=torch.bool)
    g = (torch.sigmoid(logits) - target).abs()
    total = valid.sum().to(logits.dtype).clamp(min=1.0)
    edges = torch.linspace(0, 1, bins + 1, dtype=torch.float32)
    edges[-1] += 1e-6
    w = torch.zeros_like(g)
    for i in range(bins):
        in_bin = (g >= float(edges[i])) & (g < float(edges[i + 1])) & valid
        num_in_bin = in_bin.sum().to(logits.dtype)
        w = torch.where(in_bin & (num_in_bin > 0),
                        total / num_in_bin.clamp(min=1.0), w)
    loss = bce_with_logits(logits, target) * (w / bins)
    if avg_factor is None:
        avg_factor = total
    return loss.sum() / avg_factor


def mse_loss(pred, target, weights=None, avg_factor=None):
    """Mean-squared error."""
    return _weighted((pred - target) ** 2, weights, avg_factor)


def bounded_iou_loss(pred, target, weights=None, beta=0.2, eps=1e-3,
                     avg_factor=None):
    """Bounded IoU loss on xyxy boxes: bounded terms for the centre offset
    and the size ratio of each coordinate, composed smooth-L1-wise at
    ``beta``; summed, then divided by max(avg_factor, 1)."""
    def centre_size(b):
        return ((b[..., 0] + b[..., 2]) * 0.5, (b[..., 1] + b[..., 3]) * 0.5,
                b[..., 2] - b[..., 0] + 1, b[..., 3] - b[..., 1] + 1)
    p_x, p_y, p_w, p_h = centre_size(pred)
    t_x, t_y, t_w, t_h = centre_size(target)
    dx, dy = (t_x - p_x).abs(), (t_y - p_y).abs()
    loss_dx = 1 - ((t_w - 2 * dx) / (t_w + 2 * dx + eps)).clamp(min=0)
    loss_dy = 1 - ((t_h - 2 * dy) / (t_h + 2 * dy + eps)).clamp(min=0)
    loss_dw = 1 - torch.minimum(t_w / (p_w + eps), p_w / (t_w + eps))
    loss_dh = 1 - torch.minimum(t_h / (p_h + eps), p_h / (t_h + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], dim=-1)
    loss = torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta)
    if weights is not None:
        loss = loss * weights
    loss = loss.sum()
    if avg_factor is not None:
        loss = loss / torch.clamp(torch.as_tensor(avg_factor), min=1.0)
    return loss
