"""Mask heads (Mask R-CNN, Mask Scoring R-CNN, HTC) and their targets and
losses.

Port of kgdet_tpu/models/mask_head.py:
- ``FCNMaskHead``: four 3x3 convs, a 2x2 / 2 deconv, 1x1 per-class logits
  (fcn_mask_head.py); ``with_info_flow`` adds HTC's ``conv_res``, a 1x1
  transform of the previous stage's pre-deconv features
  (htc_mask_head.py). ``conv_logits`` keeps the reference's background
  channel 0, which the JAX converter drops, so a reference .pth loads and
  the JAX package's weights come across with a zero channel there; the
  forward returns the foreground channels only.
- ``MaskIoUHead``: the mask-IoU regressor of Mask Scoring R-CNN
  (maskiou_head.py): the 14x14 RoI features with the 2x2 max-pooled
  sigmoid of the selected class's 28x28 logits, four convs (the last of
  stride 2), two fcs, per-class IoUs.
- ``FusedSemanticHead``: HTC's semantic branch (fused_semantic_head.py):
  the levels resized to the fusion level, lateral 1x1 convs summed, four
  3x3 convs, the stuff logits and a 1x1 embedding.
- ``mask_targets``: each RoI's assigned ground-truth mask cropped to the
  mask size. The JAX function runs RoIAlign over B * G one-channel maps
  with a batch index; here an image's G masks are the channels of one map,
  (B, H / s, W / s, G), gathered once through ops/roi.py::roi_align (K6 on
  the card) and each RoI takes its assigned channel. Every channel is
  sampled at the same positions, so the crops are the JAX crops.
- ``mask_loss``, ``maskiou_targets``, ``semantic_loss`` and the host-side
  ``paste_masks`` (cv2.resize, as the JAX package; without cv2 it raises
  naming it).

In a process group the losses' average factors (positive RoIs, valid
stuff pixels) are summed over the processes (parallel/dist.py::global_sum),
as the JAX ``dp`` mesh counts the global batch.

Layouts: the RoI features come in as (..., r, r, C), the mask logits go
out as (..., 2r, 2r, classes) and the semantic outputs as (B, H, W, C),
the JAX layouts; the convs run NCHW in the input's dtype.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.models.layers import ConvModule, init_normal_, \
    init_variance_scaling_
from kgdet_tpu_torch.ops.roi import roi_align
from kgdet_tpu_torch.parallel.dist import global_sum


def _conv(x, conv, stride=1, padding=0):
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), b, stride=stride,
                    padding=padding)


def _linear(x, fc):
    return F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype))


def _nchw(x):
    """(N, h, w, C) -> (N, C, h, w)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class FCNMaskHead(nn.Module):
    def __init__(self, num_classes=13, in_channels=256, conv_channels=256,
                 num_convs=4, with_info_flow=False):
        super().__init__()
        if with_info_flow:
            self.conv_res = ConvModule(conv_channels, in_channels, 1,
                                       act=False)
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_channels,
                       conv_channels, 3, act=False)
            for i in range(num_convs))
        self.upsample = nn.ConvTranspose2d(conv_channels, conv_channels, 2,
                                           stride=2)
        self.conv_logits = nn.Conv2d(conv_channels, num_classes + 1, 1)

    def init_weights(self, gen):
        """N(0, 0.01) weights, zero biases, as the JAX head."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                init_normal_(m.weight, 0.01, gen)
                nn.init.zeros_(m.bias)

    def forward(self, roi_feats, res_feat=None, return_feat=False):
        """roi_feats (N, r, r, C) -> mask logits (N, 2r, 2r, classes);
        with ``return_feat`` also the (N, r, r, C') pre-deconv features.
        ``res_feat``: the previous stage's features (information flow)."""
        x = _nchw(roi_feats)
        if hasattr(self, 'conv_res') and res_feat is not None:
            x = x + self.conv_res(_nchw(res_feat).to(x.dtype))
        for conv in self.convs:
            x = torch.relu(conv(x))
        feat = x
        x = torch.relu(F.conv_transpose2d(
            x, self.upsample.weight.to(x.dtype),
            self.upsample.bias.to(x.dtype), stride=2))
        logits = _nhwc(_conv(x, self.conv_logits))[..., 1:]
        return (logits, _nhwc(feat)) if return_feat else logits


class MaskIoUHead(nn.Module):
    """The reference feeds the sampled positive's ground-truth class mask;
    the JAX package (and so the port) feeds the best-scoring class's mask
    for every RoI, and supervises the assigned label's output."""

    def __init__(self, num_classes=13, in_channels=256, conv_channels=256,
                 fc_channels=1024, num_convs=4, num_fcs=2, roi_size=14):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels + 1 if i == 0 else conv_channels,
                      conv_channels, 3, stride=2 if i == num_convs - 1
                      else 1, padding=1) for i in range(num_convs))
        flat = conv_channels * (roi_size // 2) ** 2
        self.fcs = nn.ModuleList(
            nn.Linear(flat if i == 0 else fc_channels, fc_channels)
            for i in range(num_fcs))
        self.fc_mask_iou = nn.Linear(fc_channels, num_classes)

    def init_weights(self, gen):
        for conv in self.convs:
            init_normal_(conv.weight, 0.01, gen)
        for fc in self.fcs:
            init_variance_scaling_(fc.weight, gen, 1.0 / 3, 'uniform')
        init_normal_(self.fc_mask_iou.weight, 0.01, gen)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.zeros_(m.bias)

    def forward(self, mask_feats, mask_pred):
        """mask_feats (..., 14, 14, C), mask_pred (..., 28, 28) logits of
        the selected class -> (..., num_classes) IoU predictions."""
        lead = mask_feats.shape[:-3]
        x = _nchw(mask_feats.reshape(-1, *mask_feats.shape[-3:]))
        pred = torch.sigmoid(mask_pred.reshape(-1, 1, *mask_pred.shape[-2:])
                             .to(x.dtype))
        x = torch.cat([x, F.max_pool2d(pred, 2, 2)], dim=1)
        for conv in self.convs:
            x = torch.relu(_conv(x, conv, stride=conv.stride,
                                 padding=conv.padding))
        x = x.flatten(1)
        for fc in self.fcs:
            x = torch.relu(_linear(x, fc))
        return _linear(x, self.fc_mask_iou).reshape(*lead, -1)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of jax.image.resize's 'bilinear' along one
    axis (jax.image.scale_and_translate: the triangle kernel, widened by
    the down-scaling factor (antialias), each output's weights normalized,
    outputs whose sample lies outside the input zero)."""
    inv = n_in / n_out
    kscale = max(inv, 1.0)
    sample = (np.arange(n_out, dtype=np.float64) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float64)[:, None])
    w = np.maximum(0.0, 1.0 - x / kscale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def resize_bilinear(x, size):
    """(B, C, h, w) -> (B, C, *size) as jax.image.resize(..., 'bilinear')
    resizes a (B, h, w, C) map."""
    H, W = size
    wy = x.new_tensor(resize_weights(x.shape[2], H))
    wx = x.new_tensor(resize_weights(x.shape[3], W))
    return torch.einsum('yh,bchw,xw->bcyx', wy, x, wx)


class FusedSemanticHead(nn.Module):
    def __init__(self, num_ins=5, fusion_level=1, num_convs=4,
                 in_channels=256, conv_channels=256, num_classes=183):
        super().__init__()
        self.fusion_level = fusion_level
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels, conv_channels, 1, act=False)
            for _ in range(num_ins))
        self.convs = nn.ModuleList(
            ConvModule(conv_channels, conv_channels, 3, act=False)
            for _ in range(num_convs))
        self.conv_logits = nn.Conv2d(conv_channels, num_classes, 1)
        self.conv_embedding = ConvModule(conv_channels, conv_channels, 1,
                                         act=False)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_normal_(m.weight, 0.01, gen)
                nn.init.zeros_(m.bias)

    def forward(self, feats):
        """feats: the neck's (B, C, H_l, W_l) levels -> (stuff logits
        (B, H, W, classes), embedding (B, H, W, C)) at the fusion level."""
        assert len(feats) == len(self.lateral_convs)
        ref = feats[self.fusion_level]
        size = ref.shape[2:]
        x = self.lateral_convs[self.fusion_level](ref)
        for i, f in enumerate(feats):
            if i != self.fusion_level:
                x = x + self.lateral_convs[i](resize_bilinear(f, size))
        for conv in self.convs:
            x = torch.relu(conv(x))
        logits = _conv(x, self.conv_logits)
        embedding = torch.relu(self.conv_embedding(x))
        return _nhwc(logits), _nhwc(embedding)


def semantic_loss(logits, gt_seg, ignore_label=255, loss_weight=0.2):
    """Pixel cross entropy on the stuff map (fused_semantic_head.py loss):
    logits (B, H, W, C), gt_seg (B, H, W) int; ``ignore_label`` and labels
    outside [0, C) take no part; the mean over the others."""
    logits = logits.float()
    C = logits.shape[-1]
    valid = (gt_seg != ignore_label) & (gt_seg >= 0) & (gt_seg < C)
    labels = gt_seg.clamp(0, C - 1).long()
    ce = -F.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    ce = torch.where(valid, ce, torch.zeros_like(ce))
    return loss_weight * ce.sum() / global_sum(valid.sum().float()).clamp(
        min=1.0)


def mask_targets(gt_masks, assigned_gt, proposals, mask_stride,
                 out_size=28):
    """Each proposal's assigned ground-truth mask cropped to (out, out).
    gt_masks (B, G, Hm, Wm) in {0, 1} at 1 / mask_stride; assigned_gt
    (B, R) int; proposals (B, R, 4) in image coordinates. Returns (B, R,
    out, out) soft targets in [0, 1]."""
    with torch.no_grad():
        crops = roi_align(gt_masks.float().permute(0, 2, 3, 1), proposals,
                          out_size=out_size, spatial_scale=1.0 / mask_stride,
                          sample_num=2)
        idx = assigned_gt.long()[..., None, None, None].expand(
            *crops.shape[:-1], 1)
        return crops.gather(-1, idx)[..., 0]


def _pick_class(mask_logits, labels):
    """mask_logits (B, R, S, S, C) at each RoI's 1-based class ``labels``
    (B, R) -> (B, R, S, S) f32."""
    C = mask_logits.shape[-1]
    idx = (labels.long() - 1).clamp(0, C - 1)
    return mask_logits.float().gather(
        -1, idx[..., None, None, None].expand(*mask_logits.shape[:-1], 1)
    )[..., 0]


def mask_loss(mask_logits, targets, labels, pos_weights):
    """Per-pixel BCE on each positive RoI's own-class channel: mask_logits
    (B, R, S, S, C), targets (B, R, S, S), labels (B, R) 1-based,
    pos_weights (B, R)."""
    logits = _pick_class(mask_logits, labels)
    bce = logits.clamp(min=0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))
    per_roi = bce.mean((-1, -2))
    return (per_roi * pos_weights).sum() / global_sum(
        pos_weights.sum()).clamp(min=1.0)


def maskiou_targets(mask_logits_cls, mask_t, thr=0.5):
    """IoU between the thresholded predicted mask and its target crop
    (the in-box IoU; the reference rescales the target's area by the
    inside-box ratio): (B, R, S, S) logits and targets -> (B, R)."""
    pred = (torch.sigmoid(mask_logits_cls.float()) > thr).float()
    tgt = (mask_t > thr).float()
    inter = (pred * tgt).sum((-1, -2))
    union = pred.sum((-1, -2)) + tgt.sum((-1, -2)) - inter
    return inter / union.clamp(min=1e-7)


def paste_masks(det_boxes, mask_probs, img_h, img_w, thr=0.5):
    """On the host: (N, S, S) mask probabilities pasted into binary (img_h,
    img_w) uint8 masks at their boxes (N, 4+) xyxy in image coordinates
    (fcn_mask_head.get_seg_masks), resized with cv2 as the JAX package
    does. Returns a list of masks."""
    from kgdet_tpu_torch.data.image_io import require_cv2
    cv2 = require_cv2('pasting masks')
    out = []
    for box, prob in zip(np.asarray(det_boxes), np.asarray(mask_probs)):
        x1, y1, x2, y2 = box[:4]
        w = max(int(round(x2 - x1 + 1)), 1)
        h = max(int(round(y2 - y1 + 1)), 1)
        x1 = int(max(round(x1), 0))
        y1 = int(max(round(y1), 0))
        m = cv2.resize(prob.astype(np.float32), (w, h))
        full = np.zeros((img_h, img_w), np.uint8)
        ww = min(w, img_w - x1)
        hh = min(h, img_h - y1)
        if ww > 0 and hh > 0:
            full[y1:y1 + hh, x1:x1 + ww] = (m[:hh, :ww] >= thr)
        out.append(full)
    return out
