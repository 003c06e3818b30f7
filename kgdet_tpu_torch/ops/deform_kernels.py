"""K1: fused deformable gather + contraction (csrc/deform_fused.cu).

Port of kgdet_tpu/ops/pallas_deform.py::_fused_impl / deform_conv_fused
(kernel ``_fused_kernel``) and the inference path of
``deform_columns_dual``. The TPU tiling machinery (VMEM tiers, row pairing,
the vw walk) has no meaning here; the kernel computes the same function.

On a CPU tensor ``deform_conv_fused`` runs its plain version
``deform_conv_fused_ref``; on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from kgdet_tpu_torch.ops import _build
from kgdet_tpu_torch.ops.deform import bilinear_gather, pad_min2, \
    prep_indices


def deform_conv_fused_ref(feat, pos_yx, weight):
    """Plain version: gather the columns, then contract.
    (B,H,W,C), (B,P,K,2), (K,C,F) -> (B,P,F) in feat's dtype."""
    cols = bilinear_gather(feat, pos_yx)
    return torch.einsum('bpkc,kcf->bpf', cols, weight.to(feat.dtype))


def deform_conv_fused(feat, pos_yx, weight):
    """out[b,p,:] = sum_k sum_c bilinear(feat[b], pos[b,p,k])[c] *
    weight[k,c,:]. feat (B,H,W,C) f32|bf16, pos_yx (B,P,K,2) absolute
    (y, x), weight (K,C,F). Returns (B,P,F) in feat's dtype; on CUDA the
    sampled columns never reach device memory."""
    if feat.device.type == 'cpu':
        return deform_conv_fused_ref(feat, pos_yx, weight)
    feat = pad_min2(feat).contiguous()
    B, H, W, C = feat.shape
    P, K = pos_yx.shape[1], pos_yx.shape[2]
    if pos_yx.shape != (B, P, K, 2) or weight.shape[:2] != (K, C):
        raise ValueError(f'shape mismatch: feat {tuple(feat.shape)}, pos '
                         f'{tuple(pos_yx.shape)}, weight '
                         f'{tuple(weight.shape)}')
    Fo = weight.shape[2]
    starts, w4 = prep_indices(pos_yx, H, W)
    weight = weight.to(feat.dtype).contiguous()
    out = torch.empty((B, P, Fo), dtype=feat.dtype, device=feat.device)
    _build.require_cuda(feat, starts, w4, weight, out)
    lib = _build.load('deform_fused')
    rc = lib.kgdet_deform_fused(
        feat.data_ptr(), starts.data_ptr(), w4.data_ptr(), weight.data_ptr(),
        out.data_ptr(), B, H * W, C, P, K, Fo, _build.dtype_code(feat),
        _build.stream_ptr(feat.device))
    _build.check(rc, 'deform_fused')
    deform_conv_fused.launches += 1
    return out


deform_conv_fused.launches = 0


def deform_columns_dual(cls_feat, pts_feat, pos_yx, w_cls, w_pts, taps,
                        conv=deform_conv_fused):
    """Inference path of the cascade block's multi-column deformable convs.

    cls_feat/pts_feat: (B, H, W, C); pos_yx: (B, P, K, 2), K == sum(taps);
    w_cls/w_pts: sequences of (t, C, F) per column. One ``conv`` call per
    (column, branch). Returns (cls_cat, kpt_cat), each (B, P, len(taps)*F),
    pre-activation, column-major."""
    cls_out, pts_out = [], []
    lo = 0
    for ci, t in enumerate(taps):
        pcol = pos_yx[:, :, lo:lo + t]
        lo += t
        cls_out.append(conv(cls_feat, pcol, w_cls[ci]))
        pts_out.append(conv(pts_feat, pcol, w_pts[ci]))
    return torch.cat(cls_out, dim=-1), torch.cat(pts_out, dim=-1)
