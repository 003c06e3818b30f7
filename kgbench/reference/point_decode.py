"""Plain reference of the point families' decode: head outputs to padded
detections.

The stage-3 outputs of each level; per image the ``nms_pre`` cells of the
highest class score (a stable sort: ties keep the lower cell); boxes and
keypoints from the cell offsets (``offset * stride + cell centre``, (y, x)
pairs for the keypoints), clamped to the resized image, divided by the
scale factor; per class a greedy NMS in score order (the IoU of the
reference CUDA NMS, ``+1`` on widths and heights; ties keep the earlier
candidate), at most ``max_per_class`` kept; then the ``max_per_img`` best
over all classes, class by class and in keep order on ties. Empty slots are
zero and not valid.

``dtype`` is that of the arithmetic: float32 for the reference, bfloat16
for the control.
"""
from __future__ import annotations

import numpy as np
import torch


def _iou_over(boxes, thr):
    """(N, 4) boxes -> (N, N) bool: IoU > thr, as the reference CUDA NMS
    computes it."""
    a, b = boxes[:, None, :], boxes[None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0]) + 1.0).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1]) + 1.0).clamp(min=0)
    inter = iw * ih
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    iou = inter / torch.clamp(area_a + area_b - inter, min=1e-10)
    return (iou > thr).cpu().numpy()


def _greedy(scores, over, limit):
    """Candidate indices kept, in keep order: score order, ties the lower
    index first; a candidate goes when it overlaps one kept before it."""
    order = np.argsort(-scores, kind='stable')
    kept = []
    for i in order:
        if not np.isfinite(scores[i]):
            break
        if kept and over[i, kept].any():
            continue
        kept.append(i)
        if len(kept) == limit:
            break
    return kept


def decode(level_outs, strides, img_hw, scale_factor, test, dtype):
    """level_outs: per level a dict with cls (S, B, h, w, C), kpt
    (S, B, h, w, 2K), bbox (S, B, h, w, 4). img_hw (B, 2) resized extents,
    scale_factor (B,), both float32. Returns numpy det_bboxes (B, M, 5),
    det_labels (B, M), det_kpts (B, M, 3K), valid (B, M)."""
    dev = level_outs[0]['cls'].device
    img_hw = torch.as_tensor(img_hw, device=dev).to(dtype)
    sf = torch.as_tensor(scale_factor, device=dev).to(dtype)
    B = img_hw.shape[0]
    h_img, w_img = img_hw[:, 0, None], img_hw[:, 1, None]
    all_s, all_b, all_k = [], [], []
    for outs, stride in zip(level_outs, strides):
        cls, kpt, box = (outs[k][-1].to(dtype) for k in ('cls', 'kpt',
                                                          'bbox'))
        _, h, w, C = cls.shape
        P = h * w
        ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing='ij')
        cx = (xs.reshape(P) * stride).to(dtype)
        cy = (ys.reshape(P) * stride).to(dtype)
        scores = torch.sigmoid(cls.reshape(B, P, C))
        box = box.reshape(B, P, 4)
        kpt = kpt.reshape(B, P, -1, 2)
        cx, cy = cx.expand(B, P), cy.expand(B, P)
        if 0 < test['nms_pre'] < P:
            top = torch.sort(scores.amax(-1), dim=-1, descending=True,
                             stable=True)[1][:, :test['nms_pre']]
            scores = scores.gather(1, top[..., None].expand(-1, -1, C))
            box = box.gather(1, top[..., None].expand(-1, -1, 4))
            kpt = kpt.gather(1, top[..., None, None].expand(
                -1, -1, kpt.shape[2], 2))
            cx, cy = cx.gather(1, top), cy.gather(1, top)
        x1 = box[..., 0] * stride + cx
        y1 = box[..., 1] * stride + cy
        x2 = box[..., 2] * stride + cx
        y2 = box[..., 3] * stride + cy
        boxes = torch.stack([
            torch.minimum(x1.clamp(min=0), w_img),
            torch.minimum(y1.clamp(min=0), h_img),
            torch.minimum(x2.clamp(min=0), w_img),
            torch.minimum(y2.clamp(min=0), h_img)], -1)
        kx = kpt[..., 1] * stride + cx[..., None]
        ky = kpt[..., 0] * stride + cy[..., None]
        kx = torch.minimum(kx.clamp(min=0), w_img[..., None])
        ky = torch.minimum(ky.clamp(min=0), h_img[..., None])
        all_s.append(scores)
        all_b.append(boxes)
        all_k.append(torch.stack([kx, ky], -1))
    scores = torch.cat(all_s, 1)
    boxes = torch.cat(all_b, 1) / sf[:, None, None]
    kxy = torch.cat(all_k, 1) / sf[:, None, None, None]
    kpts = torch.cat([kxy, torch.ones_like(kxy[..., :1])], -1)
    N, K = kpts.shape[1], kpts.shape[2]

    M, per_cls = test['max_per_img'], test['max_per_class']
    out_b = np.zeros((B, M, 5), np.float32)
    out_l = np.zeros((B, M), np.int64)
    out_k = np.zeros((B, M, K * 3), np.float32)
    valid = np.zeros((B, M), bool)
    s_np = scores.float().cpu().numpy()
    b_np = boxes.float().cpu().numpy()
    k_np = kpts.float().reshape(B, N, K * 3).cpu().numpy()
    for b in range(B):
        over = _iou_over(boxes[b], test['nms_iou_thr'])
        flat = []                                   # (score, label, index)
        for c in range(s_np.shape[2]):
            sc = np.where(s_np[b, :, c] > test['score_thr'], s_np[b, :, c],
                          -np.inf)
            flat += [(sc[i], c, i) for i in _greedy(sc, over, per_cls)]
        keys = np.array([-f[0] for f in flat], np.float64)
        for m, j in enumerate(np.argsort(keys, kind='stable')[:M]):
            score, c, i = flat[j]
            out_b[b, m, :4], out_b[b, m, 4] = b_np[b, i], score
            out_l[b, m], out_k[b, m], valid[b, m] = c, k_np[b, i], True
    return out_b, out_l, out_k, valid
