"""Point-set primitives: grid generation and RepPoints -> bbox transforms.

Port of kgdet_tpu/ops/points.py (grid_points, points2bbox, yx_to_xy,
offsets_to_coords), fixed-shape batched tensor ops throughout.
"""
from __future__ import annotations

import torch


def grid_points(feat_h: int, feat_w: int, stride: int,
                dtype=torch.float32, device=None):
    """(H*W, 3) tensor of (x, y, stride) grid-point coordinates
    (row-major)."""
    xs = torch.arange(feat_w, dtype=dtype, device=device) * stride
    ys = torch.arange(feat_h, dtype=dtype, device=device) * stride
    xx = xs.repeat(feat_h)
    yy = ys.repeat_interleave(feat_w)
    ss = torch.full((feat_h * feat_w,), stride, dtype=dtype, device=device)
    return torch.stack([xx, yy, ss], dim=-1)


def points2bbox(pts, method='moment', moment_transfer=None, moment_mul=0.01,
                y_first=True):
    """Convert point sets (..., 2N) -> boxes (..., 4) [x1, y1, x2, y2].

    ``moment``: box centered at the point mean with half-extent
    std * exp(learned transfer), where the transfer passes only
    ``moment_mul`` of its gradient. std is the unbiased (n-1) estimator with
    1e-6 inside the sqrt, as in the JAX reference.
    """
    shape = pts.shape
    n = shape[-1] // 2
    pts = pts.reshape(*shape[:-1], n, 2)
    if y_first:
        pts_y, pts_x = pts[..., 0], pts[..., 1]
    else:
        pts_x, pts_y = pts[..., 0], pts[..., 1]
    if method == 'minmax':
        return torch.stack([pts_x.amin(-1), pts_y.amin(-1),
                            pts_x.amax(-1), pts_y.amax(-1)], dim=-1)
    if method == 'partial_minmax':
        px, py = pts_x[..., :4], pts_y[..., :4]
        return torch.stack([px.amin(-1), py.amin(-1),
                            px.amax(-1), py.amax(-1)], dim=-1)
    if method == 'moment':
        mean_x = pts_x.mean(-1)
        mean_y = pts_y.mean(-1)
        nb = pts_x.shape[-1] - 1
        var_x = ((pts_x - mean_x[..., None]) ** 2).sum(-1) / nb
        var_y = ((pts_y - mean_y[..., None]) ** 2).sum(-1) / nb
        std_x = torch.sqrt(var_x + 1e-6)
        std_y = torch.sqrt(var_y + 1e-6)
        mt = (moment_transfer * moment_mul
              + moment_transfer.detach() * (1 - moment_mul))
        half_w = std_x * torch.exp(mt[0])
        half_h = std_y * torch.exp(mt[1])
        return torch.stack([mean_x - half_w, mean_y - half_h,
                            mean_x + half_w, mean_y + half_h], dim=-1)
    raise ValueError(f'unknown transform method: {method}')


def yx_to_xy(pts):
    """Swap interleaved (y, x) pairs to (x, y) pairs along the last axis."""
    shape = pts.shape
    p = pts.reshape(*shape[:-1], shape[-1] // 2, 2)
    return p.flip(-1).reshape(shape)


def offsets_to_coords(offsets, centers_xy, stride, y_first=True):
    """Decode per-point offsets (..., P, 2N) in stride units around grid
    centers (P, 2) to interleaved absolute (x, y) image coordinates."""
    if y_first:
        offsets = yx_to_xy(offsets)
    n = offsets.shape[-1] // 2
    return offsets * stride + centers_xy.repeat(1, n)
