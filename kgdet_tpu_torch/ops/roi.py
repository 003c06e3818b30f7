"""RoI feature extraction (RoIAlign / RoIPool) on per-image boxes.

Port of kgdet_tpu/ops/roi.py, with the legacy mmdet-v1 sampling of the JAX
functions (not torchvision's or mmcv's): a box's corners are scaled by
``spatial_scale`` with no half-pixel shift, its size is ``max(x2 - x1, 1)``,
and RoIAlign samples each of its ``out_size`` x ``out_size`` bins at
``sample_num`` x ``sample_num`` points ``(i + (j + .5) / s) * bin`` from the
box's corner, bilinearly, corners outside the map weighing 0, and averages
them. RoIPool takes the max over a bin's rounded integer cells.

The JAX functions take (R, 5) rois with a batch index and gather from
``feat[batch_idx]``, a copy of the map per RoI that XLA fuses away on the
TPU; eager PyTorch would materialize it (about 92 GB for Faster R-CNN's
2 x 1000 test RoIs on a bf16 FPN). Here the boxes come per image, (B, R, 4),
and the samples of every RoI of an image are gathered from that image's map
as one (B, R, n * n, 2) position tensor, n = out_size * sample_num: the
function of kernel K6 (ops/deform_kernels.py::deform_sample_cols, one map's
bilinear columns), which serves it through ``deform_sample_hybrid`` (K6
forward, the sampling backward K3 as its gradient; their plain versions
where ``ops.runs_kernel`` says so). Positions are f32 whatever the map's
dtype.

``roi_pool`` has no caller in either package. It takes the max over each
bin's rectangle from a two-dimensional table of power-of-two block maxima
of the map, four lookups a bin, instead of the JAX function's masked copy
of the map per RoI.
"""
from __future__ import annotations

import torch

from kgdet_tpu_torch.ops.deform_kernels import deform_sample_hybrid


def _scaled_corners(boxes, spatial_scale):
    b = boxes.float() * spatial_scale
    return b[..., 0], b[..., 1], b[..., 2], b[..., 3]


def sample_grid(out_size, sample_num, device=None):
    """(out, s) offsets of a bin's samples in bins: i + (j + .5) / s."""
    i = torch.arange(out_size, dtype=torch.float32, device=device)
    j = torch.arange(sample_num, dtype=torch.float32, device=device)
    return i[:, None] + (j[None, :] + 0.5) / sample_num


def roi_positions(boxes, out_size=7, spatial_scale=1.0, sample_num=2,
                  offsets=None, gamma=0.1):
    """(..., R, 4) xyxy boxes in image coordinates -> (..., R, n * n, 2)
    f32 (y, x) sample positions on the map, n = out_size * sample_num,
    row-major over (sample row, sample column). ``offsets`` (..., R, out,
    out, 2), where given, move each bin's samples by its normalized (dy, dx)
    times ``gamma`` times the box's size (deformable RoI pooling)."""
    x1, y1, x2, y2 = _scaled_corners(boxes, spatial_scale)
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    grid = sample_grid(out_size, sample_num, boxes.device)
    n = out_size * sample_num
    ys = (y1[..., None, None] + (roi_h / out_size)[..., None, None]
          * grid).flatten(-2)                                # (..., R, n)
    xs = (x1[..., None, None] + (roi_w / out_size)[..., None, None]
          * grid).flatten(-2)
    yy = ys[..., :, None].expand(*ys.shape, n)
    xx = xs[..., None, :].expand(*xs.shape[:-1], n, n)
    if offsets is not None:
        s = sample_num

        def per_sample(o):          # (..., R, out, out) -> (..., R, n, n)
            return o.repeat_interleave(s, -2).repeat_interleave(s, -1)
        yy = yy + per_sample(offsets[..., 0].float()) * gamma \
            * roi_h[..., None, None]
        xx = xx + per_sample(offsets[..., 1].float()) * gamma \
            * roi_w[..., None, None]
    return torch.stack([yy, xx], dim=-1).flatten(-3, -2)


def _bin_mean(samples, out_size, sample_num):
    """(B, R, n * n, C) samples -> (B, R, out, out, C) bin means."""
    B, R, _, C = samples.shape
    s = sample_num
    return samples.reshape(B, R, out_size, s, out_size, s, C).mean((3, 5))


def roi_align(feat, boxes, out_size=7, spatial_scale=1.0, sample_num=2):
    """RoIAlign of a (B, H, W, C) map over per-image boxes (B, R, 4) xyxy in
    image coordinates -> (B, R, out, out, C) in the map's dtype."""
    pos = roi_positions(boxes, out_size, spatial_scale, sample_num)
    return _bin_mean(deform_sample_hybrid(feat, pos), out_size, sample_num)


def roi_pool(feat, boxes, out_size=7, spatial_scale=1.0):
    """Max RoI pooling (quantized bins, the reference's roi_pool_kernel.cu)
    of a (B, H, W, C) map over per-image boxes (B, R, 4) -> (B, R, out, out,
    C); a bin with no cell inside the map is 0."""
    B, H, W, C = feat.shape
    R = boxes.shape[1]
    x1, y1, x2, y2 = (torch.round(c).to(torch.int64)
                      for c in _scaled_corners(boxes, spatial_scale))
    roi_w = torch.clamp(x2 - x1 + 1, min=1)
    roi_h = torch.clamp(y2 - y1 + 1, min=1)
    p = torch.arange(out_size, device=feat.device)

    def edges(start, size, limit):
        lo = start[..., None] + torch.div(size[..., None] * p, out_size,
                                          rounding_mode='floor')
        hi = start[..., None] - torch.div(-size[..., None] * (p + 1),
                                          out_size, rounding_mode='floor')
        return lo.clamp(0, limit), hi.clamp(0, limit)
    hs, he = edges(y1, roi_h, H)                            # (B, R, out)
    ws, we = edges(x1, roi_w, W)
    table, levels = _block_max_table(feat)
    KH, KW = levels
    hs, he = hs[..., :, None], he[..., :, None]              # bin rows
    ws, we = ws[..., None, :], we[..., None, :]              # bin columns
    empty = (he <= hs) | (we <= ws)                         # (B, R, out, out)
    kh = _floor_log2((he - hs).clamp(min=1))
    kw = _floor_log2((we - ws).clamp(min=1))
    rows = (hs.expand_as(empty), (he - (1 << kh)).clamp(min=0))
    cols = (ws.expand_as(empty), (we - (1 << kw)).clamp(min=0))
    level = (kh * KW + kw) * (H * W)
    corners = [level + r * W + c for r in rows for c in cols]
    idx = torch.stack(corners, dim=-1).reshape(B, -1)       # (B, R*o*o*4)
    vals = torch.gather(table, 1, idx[..., None].expand(-1, -1, C))
    out = vals.reshape(B, R, out_size, out_size, 4, C).amax(-2)
    return torch.where(empty[..., None], torch.zeros_like(out), out)


def _floor_log2(n):
    """floor(log2(n)) of positive int64 tensors, exactly."""
    k = torch.zeros_like(n)
    while bool((n >> (k + 1) > 0).any()):
        k = k + (n >> (k + 1) > 0).to(n.dtype)
    return k


def _block_max_table(feat):
    """(B, KH * KW * H * W, C) maxima of the map over 2^kh x 2^kw blocks
    anchored at each cell (kh < KH, kw < KW), levels row-major; an entry
    whose block would leave the map is not read."""
    B, H, W, C = feat.shape

    def doubled(t, dim, step):      # max(t[i], t[i + step]) where in range
        n = t.shape[dim]
        if step >= n:
            return t
        head = torch.maximum(t.narrow(dim, 0, n - step),
                             t.narrow(dim, step, n - step))
        return torch.cat([head, t.narrow(dim, n - step, step)], dim=dim)
    KH, KW = H.bit_length(), W.bit_length()
    by_rows = [feat]
    for k in range(1, KH):
        by_rows.append(doubled(by_rows[-1], 1, 1 << (k - 1)))
    levels = []
    for t in by_rows:
        for k in range(KW):
            if k:
                t = doubled(t, 2, 1 << (k - 1))
            levels.append(t)
    return torch.stack(levels, dim=1).reshape(B, -1, C), (KH, KW)
