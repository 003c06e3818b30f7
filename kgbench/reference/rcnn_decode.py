"""Plain reference of the R-CNN test decode: the box head's outputs on the
proposals to padded detections.

Per proposal the softmax over the 14 logits (background first), zero for a
missing proposal; its best foreground class's deltas (slice c + 1 for
class c; stds 0.1, 0.1, 0.2, 0.2) refine it into one box that every class
shares (mmdetection v1 decodes a box a class; the program keeps one, and so
does this reference), clamped to the resized image and divided by the scale
factor. Then per class a greedy NMS on the original image's boxes (+1
widths; ties the earlier proposal first) over the scores above
``score_thr``, at most ``max_per_class`` kept; then the ``max_per_img``
best over all classes, class by class and in keep order on ties. Empty
slots are zero and not valid.

``dtype`` is that of the arithmetic: float32 for the reference, bfloat16
for the control.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from kgbench.reference.faster_rcnn import clamp_boxes, delta2bbox
from kgbench.reference.point_decode import _greedy, _iou_over

TARGET_STDS = (0.1, 0.1, 0.2, 0.2)


def decode(roi_cls, roi_reg, props, valid, img_hw, scale_factor, test,
           dtype):
    """roi_cls (B, R, C + 1), roi_reg (B, R, 4 (C + 1)), props (B, R, 4),
    valid (B, R), img_hw (B, 2), scale_factor (B,), all on one device.
    Returns numpy det_bboxes (B, M, 5), det_labels (B, M), valid (B, M)."""
    dev = roi_cls.device
    B, R = props.shape[:2]
    img_hw = torch.as_tensor(img_hw, device=dev).to(dtype)
    sf = torch.as_tensor(scale_factor, device=dev).to(dtype)
    valid = torch.as_tensor(valid, device=dev)
    scores = F.softmax(roi_cls.to(dtype), dim=-1)
    fg = torch.where(valid[..., None], scores[..., 1:], 0.0)
    reg = roi_reg.to(dtype).reshape(B, R, -1, 4)
    best = fg.argmax(-1)
    reg_best = reg.gather(2, (best + 1)[..., None, None].expand(
        B, R, 1, 4))[:, :, 0]
    boxes = clamp_boxes(delta2bbox(props.to(dtype), reg_best, TARGET_STDS),
                        img_hw)
    boxes = boxes / sf[:, None, None]

    M, per_cls = test['max_per_img'], test['max_per_class']
    out_b = np.zeros((B, M, 5), np.float32)
    out_l = np.zeros((B, M), np.int64)
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
    return out_b, out_l, out_v
