"""Inference decoding + on-device NMS -> fixed-size padded detections.

Port of kgdet_tpu/core/postprocess.py. Per image (stage-3 outputs only):
per-level top-``nms_pre`` by max class score -> decode points to image
coordinates -> clamp to the resized image -> rescale to original
coordinates -> keypoint visibility 1 -> multiclass NMS carrying keypoints.
All shapes are static; only the final padded tensors leave the device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from kgdet_tpu.config import TestConfig
from kgdet_tpu_torch.ops.nms import multiclass_nms_kp
from kgdet_tpu_torch.ops.points import yx_to_xy


def decode_raw(level_outs: List[Dict], level_points: Sequence,
               img_hw, scale_factor, cfg: TestConfig, num_keypts: int = 294):
    """Per-level top-k decode to original-image coordinates, no NMS.
    Returns (bboxes (B, N, 4), scores (B, N, C), kpts (B, N, K*3))."""
    mlvl_scores, mlvl_bboxes, mlvl_kpts = [], [], []
    B = level_outs[0]['cls'].shape[1]
    img_hw = img_hw.float()
    w = img_hw[:, 1][:, None]
    h = img_hw[:, 0][:, None]
    for outs, points in zip(level_outs, level_points):
        stride = points[0, 2]
        centers = points[:, :2]
        P = centers.shape[0]
        scores = torch.sigmoid(outs['cls'][-1].float().reshape(B, P, -1))
        bbox = outs['bbox'][-1].float().reshape(B, P, 4)
        kpt = outs['kpt'][-1].float().reshape(B, P, -1)
        centers_b = centers[None].expand(B, P, 2)

        if 0 < cfg.nms_pre < P:
            # stable descending sort: ties keep the lower index first, like
            # jax.lax.top_k
            topk = torch.sort(scores.amax(-1), dim=-1, descending=True,
                              stable=True)[1][:, :cfg.nms_pre]

            def take(t):
                return t.gather(1, topk[..., None].expand(-1, -1,
                                                          t.shape[-1]))
            scores, bbox, kpt, centers_b = (take(scores), take(bbox),
                                            take(kpt), take(centers_b))

        n = bbox.shape[1]
        bboxes = bbox * stride + torch.cat([centers_b, centers_b], dim=-1)
        bboxes = torch.stack([
            torch.minimum(bboxes[..., 0].clamp(min=0), w),
            torch.minimum(bboxes[..., 1].clamp(min=0), h),
            torch.minimum(bboxes[..., 2].clamp(min=0), w),
            torch.minimum(bboxes[..., 3].clamp(min=0), h)], dim=-1)

        kpt_xy = yx_to_xy(kpt).reshape(B, n, num_keypts, 2)
        kpt_xy = kpt_xy * stride + centers_b[:, :, None, :]
        kx = torch.minimum(kpt_xy[..., 0].clamp(min=0), w[..., None])
        ky = torch.minimum(kpt_xy[..., 1].clamp(min=0), h[..., None])
        kpts = torch.stack([kx, ky, torch.ones_like(kx)], dim=-1)

        mlvl_scores.append(scores)
        mlvl_bboxes.append(bboxes)
        mlvl_kpts.append(kpts)

    scores = torch.cat(mlvl_scores, dim=1)
    bboxes = torch.cat(mlvl_bboxes, dim=1)
    kpts = torch.cat(mlvl_kpts, dim=1)

    sf = scale_factor.float()[:, None, None]
    bboxes = bboxes / sf
    kpts = torch.cat([kpts[..., :2] / sf[..., None], kpts[..., 2:]], dim=-1)
    return bboxes, scores, kpts.reshape(B, kpts.shape[1], num_keypts * 3)


def nms_detections(bboxes, scores, kpts, cfg: TestConfig):
    """Batched multiclass NMS over raw decoded tensors -> padded dets."""
    det_bboxes, det_labels, det_kpts, valid = multiclass_nms_kp(
        bboxes, scores, kpts, cfg.score_thr, cfg.nms_iou_thr,
        max_per_class=cfg.max_per_class, max_per_img=cfg.max_per_img,
        nms_type=cfg.nms_type, soft_sigma=cfg.soft_nms_sigma,
        soft_min_score=cfg.soft_nms_min_score)
    return {'det_bboxes': det_bboxes, 'det_labels': det_labels,
            'det_kpts': det_kpts, 'valid': valid}


def decode_detections(level_outs: List[Dict], level_points: Sequence,
                      img_hw, scale_factor, cfg: TestConfig,
                      num_keypts: int = 294):
    """Head outputs -> dict of det_bboxes (B, M, 5), det_labels (B, M),
    det_kpts (B, M, K*3), valid (B, M). img_hw: (B, 2) resized extents;
    scale_factor: (B,) original -> resized."""
    return nms_detections(*decode_raw(level_outs, level_points, img_hw,
                                      scale_factor, cfg, num_keypts), cfg)


def detections_to_per_class(dets, num_classes=13):
    """Host side: padded detections -> per image (bboxes_per_class,
    scores_per_class, kpts_per_class), the reference's bbox2result_kp
    layout."""
    def host(t):
        return t.detach().cpu().numpy() if torch.is_tensor(t) \
            else np.asarray(t)
    det_bboxes, det_labels = host(dets['det_bboxes']), host(dets['det_labels'])
    det_kpts, valid = host(dets['det_kpts']), host(dets['valid'])
    out = []
    for b in range(det_bboxes.shape[0]):
        v = valid[b]
        bb, ll, kk = det_bboxes[b][v], det_labels[b][v], det_kpts[b][v]
        out.append(([bb[ll == c] for c in range(num_classes)],
                    [bb[ll == c][:, 4] for c in range(num_classes)],
                    [kk[ll == c] for c in range(num_classes)]))
    return out
