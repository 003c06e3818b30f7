"""Anchor generation (base anchors, grid anchors, valid flags).

Port of kgdet_tpu/ops/anchors.py. The base-anchor recipes are NumPy (f64
arithmetic, the same expressions in the same order, so the anchors are
bit-equal to the JAX package's); the tiling over a feature grid and the
valid flags are tensor ops on a chosen device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def base_anchors(base_size: float, scales: Sequence[float],
                 ratios: Sequence[float], ctr=None) -> np.ndarray:
    """(A, 4) base anchors around (0, 0) (or ctr), xyxy legacy (+1) style,
    scale-major: grouped by ratio, scales vary fastest."""
    w = h = base_size
    if ctr is None:
        x_ctr, y_ctr = 0.5 * (w - 1), 0.5 * (h - 1)
    else:
        x_ctr, y_ctr = ctr
    ratios = np.asarray(ratios, np.float64)
    scales = np.asarray(scales, np.float64)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
    return np.stack([
        x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
        x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)], axis=-1)


def grid_anchors(base: np.ndarray, feat_h: int, feat_w: int, stride: int,
                 device=None) -> torch.Tensor:
    """(feat_h * feat_w * A, 4) f32 anchors tiled over the feature grid,
    row-major over the grid, anchor-minor."""
    shift_x = torch.arange(feat_w, dtype=torch.float32, device=device) \
        * stride
    shift_y = torch.arange(feat_h, dtype=torch.float32, device=device) \
        * stride
    sx = shift_x.repeat(feat_h)
    sy = shift_y.repeat_interleave(feat_w)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)           # (P, 4)
    base = torch.as_tensor(np.asarray(base, np.float32), device=device)
    return (base[None] + shifts[:, None]).reshape(-1, 4)


def anchor_valid_flags(feat_h: int, feat_w: int, num_anchors: int,
                       valid_h, valid_w) -> torch.Tensor:
    """(..., feat_h * feat_w * A) validity from padded extents in grid
    cells: ints, or (B,) tensors for a (B, P) mask."""
    from kgdet_tpu_torch.ops.points import valid_flags
    return valid_flags(feat_h, feat_w, valid_h, valid_w) \
        .repeat_interleave(num_anchors, dim=-1)


def ssd_anchor_params(input_size: int, num_levels: int,
                      basesize_ratio_range) -> tuple:
    """Per-level (min_size, max_size) lists for SSD anchors: evenly stepped
    size ratios over basesize_ratio_range for levels 1..N-1, plus the
    special first-level sizes of the canonical SSD300/512 recipes."""
    lo, hi = basesize_ratio_range
    min_ratio, max_ratio = int(lo * 100), int(hi * 100)
    step = int(np.floor(max_ratio - min_ratio) / (num_levels - 2))
    min_sizes, max_sizes = [], []
    for r in range(min_ratio, max_ratio + 1, step):
        min_sizes.append(int(input_size * r / 100))
        max_sizes.append(int(input_size * (r + step) / 100))
    first = {
        (300, 0.15): (7, 15), (300, 0.2): (10, 20),
        (512, 0.1): (4, 10), (512, 0.15): (7, 15),
    }.get((input_size, lo))
    if first is None:
        # generic fallback: half the second level's ratio band
        first = (max(min_ratio // 2, 1), min_ratio)
    min_sizes.insert(0, int(input_size * first[0] / 100))
    max_sizes.insert(0, int(input_size * first[1] / 100))
    return min_sizes[:num_levels], max_sizes[:num_levels]


def ssd_base_anchors(min_size: float, max_size: float, stride: int,
                     ratios) -> np.ndarray:
    """(2 + 2*len(ratios), 4) SSD base anchors for one level, in the
    reference's order: ratio-1 at min_size, ratio-1 at sqrt(min*max), then
    (1/r, r) pairs at min_size."""
    ctr = ((stride - 1) / 2.0, (stride - 1) / 2.0)
    rows = [base_anchors(min_size, [1.0], [1.0], ctr)[0],
            base_anchors(min_size, [float(np.sqrt(max_size / min_size))],
                         [1.0], ctr)[0]]
    for r in ratios:
        rows.append(base_anchors(min_size, [1.0], [1.0 / r], ctr)[0])
        rows.append(base_anchors(min_size, [1.0], [float(r)], ctr)[0])
    return np.stack(rows)
