"""Deformable bilinear sampling: the plain PyTorch reference.

Port of kgdet_tpu/ops/deform.py. ``prep_indices`` is the analog of the TPU
path's ``pallas_deform._prep_indices``: it turns absolute (y, x) positions
into clamped row starts and 2x2 corner weights, and it is where the boundary
semantics live. The plain ``bilinear_gather`` takes its indices from it, and
the plain sampling backward from ``prep_indices_bwd``. The CUDA kernels (K1,
K2, K3, K6) are handed the positions and compute the same expressions inside
(csrc/tap_coeffs.h); ``prep_indices`` and ``prep_indices_bwd`` are their
specification, and tests/test_torch_kernels.py holds the header against
both bit for bit.
``deform_sample`` / ``deform_conv`` are the relative-offset entries (output
pixel centers at ``stride`` times the output index, optional modulation).

Out-of-bounds semantics match the reference CUDA DCN kernel: each bilinear
corner contributes only when it lies inside the feature map. Corner starts
are clamped to [0, H-2] x [0, W-2] and each loaded corner is weighted by
matching its coordinate against the tap's true corners ("clamp-match").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_min2(feat):
    """Zero-pad a (B, H, W, C) map to at least 2 rows and 2 columns: the
    2x2 footprint needs them, and zero corners keep the CUDA boundary
    semantics (hit by coarse levels of small canvases)."""
    H, W = feat.shape[1], feat.shape[2]
    if H >= 2 and W >= 2:
        return feat
    return F.pad(feat, (0, 0, 0, max(2 - W, 0), 0, max(2 - H, 0)))


def _clamped_corners(pos_yx, H: int, W: int):
    """Per axis: the clamped start c0c, the true floor c0i and the fraction,
    as (y0c, y0i, dy), (x0c, x0i, dx). Position math runs in >= f32 whatever
    the input dtype."""
    pos_dtype = torch.promote_types(pos_yx.dtype, torch.float32)
    out = []
    for axis, size in ((0, H), (1, W)):
        c = pos_yx[..., axis].to(pos_dtype)
        c0 = torch.floor(c)
        c0i = c0.to(torch.int32)
        out.append((c0i.clamp(0, max(size - 2, 0)), c0i, c - c0))
    return out


def _axis_weights(c0c, c0i, frac):
    """Lerp weight of the loaded coordinates c0c + {0, 1} against the tap's
    true corners c0i / c0i + 1 ("clamp-match"), and its exact derivative
    with respect to the coordinate, in {-1, 0, +1}. A loaded coordinate
    that matches neither true corner (an out-of-bounds corner) gets 0 for
    both."""
    zero = torch.zeros_like(frac)
    ws, ds = [], []
    for s in (0, 1):
        lo, hi = c0c + s == c0i, c0c + s == c0i + 1
        ws.append(torch.where(lo, 1.0 - frac, torch.where(hi, frac, zero)))
        ds.append(torch.where(lo, zero - 1.0, torch.where(hi, zero + 1.0,
                                                          zero)))
    return ws, ds


def _row_starts(y0c, x0c, W: int):
    return torch.stack([y0c * W + x0c, (y0c + 1) * W + x0c],
                       dim=-1).to(torch.int32)


def prep_indices(pos_yx, H: int, W: int):
    """Row starts + 2x2 lerp weights from absolute (y, x) positions.

    pos_yx: (B, P, K, 2) float. Returns starts (B, P, K, 2) int32 row
    indices [r_top, r_bottom] into the (H*W)-flattened map and w4
    (B, P, K, 4) weights ordered (tl, tr, bl, br), out-of-bounds corners
    zeroed. Position math runs in >= f32 whatever the input dtype, and the
    weights come in that dtype: f32 for f32 or bf16 positions.
    """
    (y0c, y0i, dy), (x0c, x0i, dx) = _clamped_corners(pos_yx, H, W)
    wy, _ = _axis_weights(y0c, y0i, dy)
    wx, _ = _axis_weights(x0c, x0i, dx)
    w4 = torch.stack([wy[0] * wx[0], wy[0] * wx[1],
                      wy[1] * wx[0], wy[1] * wx[1]], dim=-1)
    return _row_starts(y0c, x0c, W), w4


def prep_indices_bwd(pos_yx, H: int, W: int):
    """Backward prep: row starts and the twelve per-corner coefficients.

    The analog of the TPU path's ``_prep_indices_bwd_vw`` in the port's
    corner order (tl, tr, bl, br). Returns starts (B, P, K, 2) int32 as
    ``prep_indices`` and wd12 (B, P, K, 12), f32 for f32 or bf16 positions,
    laid out [w4 | u4 | v4]:
    w4 the lerp weights (grad_feat[corner] += w * g), u4 the d(sample)/dy
    and v4 the d(sample)/dx coefficients per corner, so that
    grad_y = sum_corner u * <g, feat[corner]> and likewise grad_x with v.
    Out-of-bounds corners are zero in all three, and on an integer
    coordinate the derivative is the one-sided one of floor()'s cell, as
    the reference CUDA col2im_coord kernel gives it.
    """
    (y0c, y0i, dy), (x0c, x0i, dx) = _clamped_corners(pos_yx, H, W)
    wy, dwy = _axis_weights(y0c, y0i, dy)
    wx, dwx = _axis_weights(x0c, x0i, dx)
    corners = ((0, 0), (0, 1), (1, 0), (1, 1))
    wd12 = torch.stack(
        [wy[i] * wx[j] for i, j in corners]
        + [dwy[i] * wx[j] for i, j in corners]
        + [wy[i] * dwx[j] for i, j in corners], dim=-1)
    return _row_starts(y0c, x0c, W), wd12


def bilinear_gather(feat, pos_yx):
    """Bilinear-sample a (B, H, W, C) map at (B, P, K, 2) absolute (y, x)
    positions -> (B, P, K, C) in feat's dtype. Corner weights are rounded
    to feat's dtype and the 4-corner sum is taken in f32, as in the JAX
    reference."""
    feat = pad_min2(feat)
    B, H, W, C = feat.shape
    P, K = pos_yx.shape[1], pos_yx.shape[2]
    starts, w4 = prep_indices(pos_yx, H, W)
    flat = feat.reshape(B, H * W, C)
    starts = starts.reshape(B, P * K, 2).long()

    def rows(idx):
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))

    corners = (rows(starts[..., 0]), rows(starts[..., 0] + 1),
               rows(starts[..., 1]), rows(starts[..., 1] + 1))
    acc = torch.promote_types(feat.dtype, torch.float32)
    w = w4.reshape(B, P * K, 4).to(feat.dtype).to(acc)
    out = sum(c.to(acc) * w[..., i:i + 1] for i, c in enumerate(corners))
    return out.to(feat.dtype).reshape(B, P, K, C)


def absolute_positions(rel_offsets_yx, H: int, W: int):
    """(B, H, W, K, 2) center-relative offsets -> (B, H*W, K, 2) absolute
    positions, in >= f32 even under bf16 compute."""
    B, K = rel_offsets_yx.shape[0], rel_offsets_yx.shape[3]
    pos_dtype = torch.promote_types(rel_offsets_yx.dtype, torch.float32)
    dev = rel_offsets_yx.device
    cy = torch.arange(H, dtype=pos_dtype, device=dev)
    cx = torch.arange(W, dtype=pos_dtype, device=dev)
    centers = torch.stack([cy.repeat_interleave(W), cx.repeat(H)], dim=-1)
    return rel_offsets_yx.to(pos_dtype).reshape(B, H * W, K, 2) \
        + centers[None, :, None, :]


def deform_sample(feat, rel_offsets_yx, stride: int = 1):
    """Sample every output pixel's K taps at center + offset.

    feat (B, H, W, C); rel_offsets_yx (B, Ho, Wo, K, 2) tap offsets (y, x)
    relative to each output pixel's input-space center (stride * output
    index), in feature-grid units, Ho/Wo = ceil(H/stride), ceil(W/stride).
    Returns the (B, Ho*Wo, K, C) columns, row-major over (Ho, Wo).

    The column gather (K6) with the sampling backward (K3) as its gradient
    (ops/deform_kernels.py::deform_sample_hybrid), or the same Function
    over their plain versions where ``ops.runs_kernel`` says so."""
    B, Ho, Wo, K, _ = rel_offsets_yx.shape
    pos_dtype = torch.promote_types(rel_offsets_yx.dtype, torch.float32)
    dev = rel_offsets_yx.device
    cy = torch.arange(Ho, dtype=pos_dtype, device=dev) * stride
    cx = torch.arange(Wo, dtype=pos_dtype, device=dev) * stride
    centers = torch.stack([cy.repeat_interleave(Wo), cx.repeat(Ho)], dim=-1)
    pos = rel_offsets_yx.to(pos_dtype).reshape(B, Ho * Wo, K, 2) \
        + centers[None, :, None, :]
    from kgdet_tpu_torch.ops.deform_kernels import deform_sample_hybrid
    return deform_sample_hybrid(feat, pos)


def deform_conv_from_samples(samples, weight, bias=None):
    """Contract gathered columns with a DCN weight: samples (B, P, K, C),
    weight (K, C, Cout), bias (Cout,) or None -> (B, P, Cout) in the
    samples' dtype, accumulated (and the bias added) in f32."""
    B, P, K, C = samples.shape
    cols = samples.reshape(B * P, K * C)
    w = weight.to(samples.dtype).reshape(K * C, -1)
    if bias is None:
        out = cols @ w
    else:       # the sum stays in f32 until the bias is in
        out = cols.float() @ w.float() + bias
    return out.to(samples.dtype).view(B, P, -1)


def deform_conv(feat, rel_offsets_yx, weight, bias=None, modulation=None,
                stride: int = 1):
    """Full deformable conv: sample + contract -> (B, Ho, Wo, Cout).
    modulation: optional (B, Ho, Wo, K) per-tap gates (the v2, "modulated",
    form); None is v1."""
    B, Ho, Wo, K, _ = rel_offsets_yx.shape
    cols = deform_sample(feat, rel_offsets_yx, stride=stride)
    if modulation is not None:
        cols = cols * modulation.reshape(B, Ho * Wo, K, 1).to(cols.dtype)
    out = deform_conv_from_samples(cols, weight, bias)
    return out.reshape(B, Ho, Wo, weight.shape[-1])


def grad_multiply(x, mul):
    """Scale only the gradient of x by ``mul`` (RepPoints gradient_mul).

    Kept as the same expression as the reference, not the identity: in bf16
    the two differ by an ulp, and the deformable stages read their offsets
    through it."""
    return mul * x + (1 - mul) * x.detach()
