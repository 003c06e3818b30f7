"""Training losses: the KGDet cascade's 3 stages x (focal cls + smooth-L1
bbox + smooth-L1 kpt), and the init/refine loss of the serial / parallel /
plain RepPoints heads.

Port of kgdet_tpu/core/loss.py. ``kgdet_loss``: all stages share one set of
assign-once targets; box and keypoint predictions are decoded to absolute
coordinates before the loss and normalized by point_base_scale * stride;
keypoint weights are normalized per instance by the visible-coordinate count
and scaled by 4. ``serial_loss``: 5 terms a level, the init stage on the
point targets and the refine stage on the MaxIoU targets, each with its own
average factor. Every term is computed in f32. In a process group the
average factors (positive counts) are summed over the processes, so that
each process's terms are its share of the global batch's, as the JAX single
program takes them over the global batch; the per-instance keypoint
normalization stays local.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from kgdet_tpu_torch.config import HeadConfig
from kgdet_tpu_torch.core.targets import PointTargets
from kgdet_tpu_torch.ops.losses import sigmoid_focal_loss, smooth_l1_loss
from kgdet_tpu_torch.ops.points import offsets_to_coords
from kgdet_tpu_torch.parallel.dist import global_sum


def kgdet_loss(level_outs: List[Dict], level_points: Sequence,
               targets_per_level: Sequence[PointTargets],
               head_cfg: HeadConfig):
    """Compute the 9-term KGDet loss.

    level_outs: per-level dicts with 'cls'/'kpt'/'bbox' stacked
    (3, B, H, W, C). level_points: per-level (P, 3) grids.
    targets_per_level: per-level PointTargets (same P).
    Returns (total_loss, dict of scalar logs).
    """
    num_classes = head_cfg.num_classes
    logs = {}
    total = 0.0
    # num_total_pos sums the per-image clamped counts over images and levels
    # (and processes)
    avg = global_sum(sum(t.num_pos.sum() for t in targets_per_level)
                     .to(torch.float32))

    for lvl, (outs, points, tgt) in enumerate(
            zip(level_outs, level_points, targets_per_level)):
        stride = points[0, 2]
        norm = head_cfg.point_base_scale * stride
        centers = points[:, :2]
        S, B = outs['cls'].shape[0], outs['cls'].shape[1]
        P = centers.shape[0]

        labels = tgt.labels.reshape(-1)
        label_w = tgt.label_weights.reshape(-1)
        bbox_gt = tgt.bbox_gt.reshape(-1, 4)
        bbox_w = tgt.bbox_weights.reshape(-1, 4)
        kpt_gt = tgt.kpt_gt.reshape(B * P, -1)
        kpt_w = tgt.kpt_weights.reshape(B * P, -1)
        # per-instance normalization: rows with visible keypoints divided by
        # their visible-coordinate count, then scaled by 4
        kpt_pos = kpt_w.sum(dim=1, keepdim=True)
        kpt_w = torch.where(kpt_pos > 0, kpt_w / kpt_pos.clamp(min=1), kpt_w)
        kpt_w = kpt_w * 4.0

        for stage in range(S):
            cls_flat = outs['cls'][stage].float().reshape(-1, num_classes)
            l_cls = sigmoid_focal_loss(
                cls_flat, labels, label_w,
                gamma=head_cfg.focal_gamma, alpha=head_cfg.focal_alpha,
                avg_factor=avg) * head_cfg.loss_cls_weights[stage]

            bbox_off = outs['bbox'][stage].float().reshape(B, P, 4)
            bbox_pred = offsets_to_coords(bbox_off, centers, stride,
                                          y_first=False).reshape(-1, 4)
            l_bbox = smooth_l1_loss(
                bbox_pred / norm, bbox_gt / norm, bbox_w,
                beta=head_cfg.smooth_l1_beta,
                avg_factor=avg) * head_cfg.loss_bbox_weights[stage]

            kpt_off = outs['kpt'][stage].float().reshape(B, P, -1)
            kpt_pred = offsets_to_coords(kpt_off, centers, stride,
                                         y_first=True).reshape(B * P, -1)
            l_kpt = smooth_l1_loss(
                kpt_pred / norm, kpt_gt / norm, kpt_w,
                beta=head_cfg.smooth_l1_beta,
                avg_factor=avg) * head_cfg.loss_kpt_weights[stage]

            suffix = f'_{stage + 1}' if len(level_outs) == 1 \
                else f'_{stage + 1}_lvl{lvl}'
            logs['loss_cls' + suffix] = l_cls
            logs['loss_bbox' + suffix] = l_bbox
            logs['loss_kpt' + suffix] = l_kpt
            total = total + l_cls + l_bbox + l_kpt

    logs['num_pos'] = avg
    return total, logs


def serial_loss(level_outs, level_points, init_targets, refine_targets,
                head_cfg: HeadConfig):
    """Init/refine loss of the serial / parallel heads.

    5 terms per level: focal cls (refine labels), smooth-L1 bbox init and
    refine, smooth-L1 kpt init and refine; separate average factors for the
    two stages; keypoint weights normalized per instance by the visible
    count (no x4: the stage loss weights carry the 2.0 / 4.0 scaling).
    head_cfg: loss_cls_weights[0], loss_bbox_weights = (init, refine),
    loss_kpt_weights = (init, refine). Returns (total, logs)."""
    num_classes = head_cfg.num_classes
    logs = {}
    total = 0.0
    avg_init, avg_refine = global_sum(torch.stack([
        sum(t.num_pos.sum() for t in targets)
        for targets in (init_targets, refine_targets)]).to(torch.float32))

    def norm_kpt_weights(w):
        pos = w.sum(dim=1, keepdim=True)
        return torch.where(pos > 0, w / pos.clamp(min=1), w)

    for lvl, (outs, points, ti, tr) in enumerate(zip(
            level_outs, level_points, init_targets, refine_targets)):
        stride = points[0, 2]
        norm = head_cfg.point_base_scale * stride
        centers = points[:, :2]
        B = outs['cls'].shape[1]
        P = centers.shape[0]

        cls_flat = outs['cls'][-1].float().reshape(-1, num_classes)
        l_cls = sigmoid_focal_loss(
            cls_flat, tr.labels.reshape(-1), tr.label_weights.reshape(-1),
            gamma=head_cfg.focal_gamma, alpha=head_cfg.focal_alpha,
            avg_factor=avg_refine) * head_cfg.loss_cls_weights[0]
        total = total + l_cls
        logs[f'loss_cls_lvl{lvl}'] = l_cls

        for stage, (tgt, avg, name) in enumerate(
                ((ti, avg_init, 'init'), (tr, avg_refine, 'refine'))):
            bbox_off = outs['bbox'][stage].float().reshape(B, P, 4)
            bbox_pred = offsets_to_coords(bbox_off, centers, stride,
                                          y_first=False).reshape(-1, 4)
            l_bbox = smooth_l1_loss(
                bbox_pred / norm, tgt.bbox_gt.reshape(-1, 4) / norm,
                tgt.bbox_weights.reshape(-1, 4),
                beta=head_cfg.smooth_l1_beta,
                avg_factor=avg) * head_cfg.loss_bbox_weights[stage]

            kpt_off = outs['kpt'][stage].float().reshape(B, P, -1)
            kpt_pred = offsets_to_coords(kpt_off, centers, stride,
                                         y_first=True).reshape(B * P, -1)
            kpt_w = norm_kpt_weights(tgt.kpt_weights.reshape(B * P, -1))
            l_kpt = smooth_l1_loss(
                kpt_pred / norm, tgt.kpt_gt.reshape(B * P, -1) / norm,
                kpt_w, beta=head_cfg.smooth_l1_beta,
                avg_factor=avg) * head_cfg.loss_kpt_weights[stage]

            total = total + l_bbox + l_kpt
            logs[f'loss_bbox_{name}_lvl{lvl}'] = l_bbox
            logs[f'loss_kpt_{name}_lvl{lvl}'] = l_kpt

    logs['num_pos_init'] = avg_init
    logs['num_pos_refine'] = avg_refine
    return total, logs
