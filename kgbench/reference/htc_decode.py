"""Plain reference of HTC's test decode: the box stages' outputs and the
mask heads' logits to padded detections with their masks.

The mask RoIs (``select``): per proposal the softmax over the 14 logits
averaged over the three stages, zero for a missing proposal; the last
stage's RoIs refined by its deltas (its stds, not clamped); the 128 of
highest best foreground score, ties the lower proposal first. The
detections: those boxes clamped to the resized image and divided by the
scale factor; per class a greedy NMS on them (+1 widths; ties the earlier
RoI first) over the scores above ``score_thr``, at most ``max_per_class``
kept; then the ``max_per_img`` best over all classes, class by class and
in keep order on ties. Each detection's mask is the sigmoid of its RoI's
averaged logits at its class (28 x 28). Empty slots are zero and not
valid.

``dtype`` is that of the arithmetic: float32 for the reference, bfloat16
for the control.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from kgbench.reference.faster_rcnn import clamp_boxes, delta2bbox
from kgbench.reference.point_decode import _greedy, _iou_over


def select(stages, valid, model, dtype=torch.float32):
    """stages: per stage (rois (B, R, 4), cls (B, R, C + 1), reg (B, R,
    4)); valid (B, R) -> the mask RoIs: (boxes (B, K, 4), foreground scores
    (B, K, C), valid (B, K))."""
    scores = sum(F.softmax(cls.to(dtype), dim=-1)
                 for _, cls, _ in stages) / len(stages)
    fg = torch.where(valid[..., None], scores[..., 1:], 0.0)
    rois, _, reg = stages[-1]
    boxes = delta2bbox(rois.to(dtype), reg.to(dtype),
                       model['cascade']['stds'][len(stages) - 1])
    best = torch.where(valid, fg.amax(-1), -1.0)
    K = min(model['mask']['rois'], best.shape[1])
    top = torch.sort(best, dim=-1, descending=True, stable=True)[1][:, :K]
    return (boxes.gather(1, top[..., None].expand(*top.shape, 4)),
            fg.gather(1, top[..., None].expand(*top.shape, fg.shape[-1])),
            valid.gather(1, top))


def decode(stages, valid, mask_logits, img_hw, scale_factor, model, dtype):
    """stages and valid as ``select`` takes them, mask_logits (B, K, S, S,
    C) of the mask RoIs, img_hw (B, 2), scale_factor (B,), all on one
    device. Returns numpy det_bboxes (B, M, 5), det_labels (B, M),
    det_masks (B, M, S, S), valid (B, M)."""
    test = model['test']
    dev = valid.device
    img_hw = torch.as_tensor(img_hw, device=dev).to(dtype)
    sf = torch.as_tensor(scale_factor, device=dev).to(dtype)
    boxes, fg, mvalid = select(stages, valid, model, dtype)
    boxes = clamp_boxes(boxes, img_hw) / sf[:, None, None]
    fg = torch.where(mvalid[..., None], fg, 0.0)
    probs = torch.sigmoid(mask_logits.to(dtype)).float().cpu().numpy()

    B, S = valid.shape[0], mask_logits.shape[2]
    M, per_cls = test['max_per_img'], test['max_per_class']
    out_b = np.zeros((B, M, 5), np.float32)
    out_l = np.zeros((B, M), np.int64)
    out_m = np.zeros((B, M, S, S), np.float32)
    out_v = np.zeros((B, M), bool)
    s_np = fg.float().cpu().numpy()
    b_np = boxes.float().cpu().numpy()
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
            out_l[b, m], out_v[b, m] = c, True
            out_m[b, m] = probs[b, i, :, :, c]
    return out_b, out_l, out_m, out_v
