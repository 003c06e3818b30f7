"""Deformable bilinear sampling: the plain PyTorch reference.

Port of kgdet_tpu/ops/deform.py. ``prep_indices`` is the analog of the TPU
path's ``pallas_deform._prep_indices``: it turns absolute (y, x) positions
into clamped row starts and 2x2 corner weights, and it is where the boundary
semantics live. Both the plain ``bilinear_gather`` and the CUDA kernel
wrapper (ops/deform_kernels.py) take their indices from it.

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


def prep_indices(pos_yx, H: int, W: int):
    """Row starts + 2x2 lerp weights from absolute (y, x) positions.

    pos_yx: (B, P, K, 2) float. Returns starts (B, P, K, 2) int32 row
    indices [r_top, r_bottom] into the (H*W)-flattened map and w4
    (B, P, K, 4) f32 weights ordered (tl, tr, bl, br), out-of-bounds corners
    zeroed. Position math runs in >= f32 whatever the input dtype.
    """
    pos_dtype = torch.promote_types(pos_yx.dtype, torch.float32)
    y = pos_yx[..., 0].to(pos_dtype)
    x = pos_yx[..., 1].to(pos_dtype)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    dy = y - y0
    dx = x - x0
    y0i = y0.to(torch.int32)
    x0i = x0.to(torch.int32)
    y0c = y0i.clamp(0, max(H - 2, 0))
    x0c = x0i.clamp(0, max(W - 2, 0))

    def axis_w(c0c, c0i, frac):
        zero = torch.zeros_like(frac)
        return [torch.where(c0c + s == c0i, 1.0 - frac,
                            torch.where(c0c + s == c0i + 1, frac, zero))
                for s in (0, 1)]

    wy = axis_w(y0c, y0i, dy)
    wx = axis_w(x0c, x0i, dx)
    w4 = torch.stack([wy[0] * wx[0], wy[0] * wx[1],
                      wy[1] * wx[0], wy[1] * wx[1]], dim=-1).float()
    starts = torch.stack([y0c * W + x0c, (y0c + 1) * W + x0c], dim=-1)
    return starts.to(torch.int32), w4


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
    w = w4.reshape(B, P * K, 4).to(feat.dtype).float()
    out = sum(c.float() * w[..., i:i + 1] for i, c in enumerate(corners))
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


def grad_multiply(x, mul):
    """Scale only the gradient of x by ``mul`` (RepPoints gradient_mul).

    Kept as the same expression as the reference, not the identity: in bf16
    the two differ by an ulp, and the deformable stages read their offsets
    through it."""
    return mul * x + (1 - mul) * x.detach()
