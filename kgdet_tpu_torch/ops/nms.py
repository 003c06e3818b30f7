"""Fixed-shape batched NMS on the device (no host round trip).

Port of kgdet_tpu/ops/nms.py: greedy selection over ``max_out`` steps, each
picking the per-row argmax (first index on ties) and suppressing overlaps
with the ``offset=1.0`` IoU convention of the reference CUDA NMS. Outputs
have fixed slots; empty slots carry index -1 and score NEG_INF. Leading
dimensions of ``scores`` are batched (all classes, and all images, run in
one loop).

K9 ``greedy_nms`` (csrc/greedy_nms.cu): hard NMS on CUDA tensors is one
launch for every row at once, a thread block a row; it replaces no TPU
kernel (the JAX package's loop is a ``lax.scan``). ``_greedy``, the Python
loop of ``max_out`` steps, is its plain version: it runs where
``ops.runs_kernel`` says so (on the CPU, inside ``ops.plain_kernels()``),
and for ``soft_nms``, whose update K9 does not compute. K9's kept indices and scores equal the loop's
on the card bit for bit.
"""
from __future__ import annotations

import math

import torch

from kgdet_tpu_torch.ops import _build, runs_kernel
from kgdet_tpu_torch.ops.kernel_cost import counted, nbytes

NEG_INF = -1e10


def pairwise_iou(box, boxes, offset=1.0):
    """IoU of box (..., 4) against boxes (..., N, 4), xyxy with +offset
    widths -> (..., N)."""
    box = box[..., None, :]
    iw = (torch.minimum(box[..., 2], boxes[..., 2])
          - torch.maximum(box[..., 0], boxes[..., 0]) + offset).clamp(min=0)
    ih = (torch.minimum(box[..., 3], boxes[..., 3])
          - torch.maximum(box[..., 1], boxes[..., 1]) + offset).clamp(min=0)
    inter = iw * ih
    area = (box[..., 2] - box[..., 0] + offset) * \
        (box[..., 3] - box[..., 1] + offset)
    areas = (boxes[..., 2] - boxes[..., 0] + offset) * \
        (boxes[..., 3] - boxes[..., 1] + offset)
    return inter / torch.clamp(area + areas - inter, min=1e-10)


def _greedy(boxes, scores, max_out, offset, update):
    """Shared greedy loop. boxes (..., N, 4) broadcastable against scores
    (..., N); update(scores, iou) -> new scores before the pick is
    removed."""
    boxes = boxes.expand(*scores.shape, 4)
    keep_idx, keep_scores = [], []
    for _ in range(max_out):
        best = scores.argmax(-1, keepdim=True)                  # (..., 1)
        best_score = scores.gather(-1, best)
        box = boxes.gather(-2, best[..., None].expand(*best.shape, 4))
        iou = pairwise_iou(box[..., 0, :], boxes, offset)
        new = update(scores, iou)
        new = new.scatter(-1, best, NEG_INF)
        valid = best_score > NEG_INF / 2
        scores = torch.where(valid, new, scores)
        keep_idx.append(torch.where(valid, best, -1)[..., 0])
        keep_scores.append(torch.where(valid, best_score,
                                       NEG_INF)[..., 0])
    return torch.stack(keep_idx, -1), torch.stack(keep_scores, -1)


def _k9_cost(boxes, scores, iou_thr, max_out, offset=1.0):
    """At most 17 operations a candidate a step (the IoU, its comparison);
    boxes and scores read once, an int64 index and an f32 score written a
    slot."""
    rows = scores.numel() // max(scores.shape[-1], 1)
    return (17 * rows * max_out * scores.shape[-1],
            nbytes(boxes, scores) + 12 * rows * max_out)


@counted('K9 greedy_nms', _k9_cost)
def greedy_nms(boxes, scores, iou_thr, max_out, offset=1.0):
    """Greedy NMS over boxes (..., N, 4) / scores (..., N) -> fixed
    (..., max_out) (keep_idx, keep_scores). Scores <= NEG_INF/2 are
    absent. Kernel K9 where ``runs_kernel(scores)``, else the loop."""
    if not runs_kernel(scores):
        return _greedy(boxes, scores, max_out, offset,
                       lambda s, iou: torch.where(iou > iou_thr, NEG_INF, s))
    return _greedy_nms_k9(boxes, scores, iou_thr, max_out, offset)


def _box_rows(boxes, lead, N):
    """boxes (..., N, 4) as (images, N, 4) f32 and how many consecutive
    score rows share an image's boxes (``rep``): boxes broadcast over the
    trailing leading dims of the scores (the classes) are not expanded;
    any other broadcast is."""
    if boxes.shape[-2:] != (N, 4) or boxes.dim() - 2 > len(lead):
        raise ValueError(f'boxes {tuple(boxes.shape)} do not broadcast '
                         f'against scores {(*lead, N)}')
    have = (1,) * (len(lead) + 2 - boxes.dim()) + tuple(boxes.shape[:-2])
    k = len(lead)
    while k and have[k - 1] == 1:
        k -= 1
    if have[:k] != tuple(lead[:k]):
        boxes, k = boxes.expand(*lead, N, 4), len(lead)
    boxes = boxes.float().reshape(-1, N, 4).contiguous()
    if boxes.data_ptr() % 16:       # the kernel reads a box as a float4
        boxes = boxes.clone()
    return boxes, math.prod(lead[k:])


def _greedy_nms_k9(boxes, scores, iou_thr, max_out, offset):
    """K9: one launch for every row of ``scores`` (f32 outputs, int64
    indices, as the loop returns them)."""
    lead, N = scores.shape[:-1], scores.shape[-1]
    rows = math.prod(lead)
    dev = scores.device
    keep_idx = torch.empty((*lead, max_out), dtype=torch.int64, device=dev)
    keep_scores = torch.empty((*lead, max_out), dtype=torch.float32,
                              device=dev)
    if rows == 0 or max_out == 0:
        return keep_idx, keep_scores
    if N == 0:
        raise ValueError('greedy_nms: no candidates to pick from')
    lib = _build.load('greedy_nms')
    boxes, rep = _box_rows(boxes, lead, N)
    # scores as (R1, R2, N) with their strides: the class-major view of the
    # (B, N, C) decode stays a view
    s = scores.float()
    s = s[None, None] if s.dim() == 1 else s[:, None] if s.dim() == 2 \
        else s.flatten(0, -3)
    # a row whose scores and boxes do not fit a block's shared memory
    # works on a global copy of its scores
    per_row = lib.kgdet_greedy_nms_scratch(N)
    scratch = torch.empty((rows, per_row), dtype=torch.float32, device=dev) \
        if per_row else None
    _build.require_cuda(keep_idx, keep_scores, boxes,
                        *([scratch] if per_row else []))
    rc = lib.kgdet_greedy_nms(
        boxes.data_ptr(), s.data_ptr(),
        scratch.data_ptr() if per_row else None, keep_idx.data_ptr(),
        keep_scores.data_ptr(), rows, s.shape[1], N, rep, *s.stride(),
        max_out, iou_thr, offset, _build.stream_ptr(dev))
    _build.check(rc, 'greedy_nms')
    greedy_nms.launches += 1
    return keep_idx, keep_scores


greedy_nms.launches = 0


def soft_nms(boxes, scores, iou_thr, max_out, sigma=0.5, min_score=1e-3,
             method='linear', offset=1.0):
    """Soft-NMS (linear/gaussian decay) with fixed output size."""
    def update(s, iou):
        if method == 'gaussian':
            decay = torch.exp(-(iou * iou) / sigma)
        else:
            decay = torch.where(iou > iou_thr, 1.0 - iou, 1.0)
        s = s * decay
        return torch.where(s < min_score, NEG_INF, s)
    return _greedy(boxes, scores, max_out, offset, update)


def multiclass_nms_kp(boxes, scores, kpts, score_thr, iou_thr,
                      max_per_class=100, max_per_img=100, offset=1.0,
                      nms_type='nms', soft_sigma=0.5, soft_min_score=1e-3):
    """Multi-class NMS carrying keypoints, fixed shapes, batched over
    leading dims.

    boxes (..., N, 4) class-agnostic xyxy; scores (..., N, C) per class
    (no background); kpts (..., N, K3). Returns (det_bboxes (..., M, 5),
    det_labels (..., M), det_kpts (..., M, K3), valid (..., M)) with
    M = max_per_img; invalid rows zeroed.
    """
    N, C = scores.shape[-2:]
    masked = torch.where(scores > score_thr, scores, NEG_INF)
    per_class = masked.transpose(-1, -2)                        # (..., C, N)
    cls_boxes = boxes[..., None, :, :]
    if nms_type == 'soft_nms':
        keep_idx, keep_scores = soft_nms(
            cls_boxes, per_class, iou_thr, max_per_class, sigma=soft_sigma,
            min_score=soft_min_score, offset=offset)
    else:
        keep_idx, keep_scores = greedy_nms(cls_boxes, per_class, iou_thr,
                                           max_per_class, offset)
    lead = keep_scores.shape[:-2]
    flat_scores = keep_scores.reshape(*lead, -1)
    flat_idx = keep_idx.reshape(*lead, -1)
    flat_labels = torch.arange(C, device=scores.device).repeat_interleave(
        max_per_class).expand(*lead, -1)
    # stable descending sort: ties keep the lower index first, like
    # jax.lax.top_k (torch.topk gives no such order)
    top_scores, top_pos = torch.sort(flat_scores, dim=-1, descending=True,
                                     stable=True)
    m = min(max_per_img, flat_scores.shape[-1])
    top_scores, top_pos = top_scores[..., :m], top_pos[..., :m]
    sel_idx = flat_idx.gather(-1, top_pos)
    sel_labels = flat_labels.gather(-1, top_pos)
    valid = top_scores > NEG_INF / 2
    safe_idx = sel_idx.clamp(0, N - 1)

    def take(t):
        return t.gather(-2, safe_idx[..., None].expand(*safe_idx.shape,
                                                       t.shape[-1]))

    det_boxes = torch.where(valid[..., None], take(boxes), 0)
    det_scores = torch.where(valid, top_scores, 0)
    det_bboxes = torch.cat([det_boxes, det_scores[..., None]], dim=-1)
    det_labels = torch.where(valid, sel_labels, 0)
    det_kpts = torch.where(valid[..., None], take(kpts), 0)
    return det_bboxes, det_labels, det_kpts, valid
