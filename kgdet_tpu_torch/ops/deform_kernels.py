"""The deformable sampling kernels, the one-map deformable conv and the
cascade block's dual path.

K1 ``deform_conv_fused`` (csrc/deform_fused.cu): fused gather + contraction,
the inference path. Port of kgdet_tpu/ops/pallas_deform.py::_fused_impl
(kernel ``_fused_kernel``); under differentiation the same entry runs the
autograd Function over K6 and K3, as the JAX package's custom_vjp does.
K2 ``deform_sample_split`` (csrc/deform_split.cu): all taps sampled once
on both branch maps into per-column, per-branch tensors, the training
forward. Port of ``deform_sample_split_pallas`` (kernel ``_split_kernel``).
K3 ``deform_sample_bwd`` (csrc/deform_bwd.cu): the backward of bilinear
sampling. Port of ``_deform_bwd_vw`` (kernel ``_bwd_kernel_vw``) and, the
same function, the older ``_bwd_kernel`` / ``_bwd_kernel_v2``.
K6 ``deform_sample_cols`` (csrc/deform_sample.cu): the bilinear columns of
one map, the training forward of a one-map deformable conv. Port of
``deform_sample_pallas`` (kernel ``_sample_kernel``); ``deform_sample_hybrid``
pairs it with K3 as its backward.
``deform_columns_dual`` is the block-level entry of the KGDet head: K1 per
(column, branch) when no gradient is wanted, else the autograd Function
over K2 and K3. The TPU tiling machinery (VMEM tiers, row pairing, the vw
walk, the raw six-dimensional column layout) has no meaning here; the
kernels compute the same functions.

On a CPU tensor each wrapper runs its plain version (``*_ref``); on a CUDA
tensor it launches its kernel or raises. K2 and K6 take the absolute
positions themselves and do the index math of ``ops/deform.py::prep_indices``
inside the kernel (csrc/tap_coeffs.h, held against ``prep_indices`` bit for
bit by tests/test_torch_kernels.py): a call is argument checks, one
``torch.empty`` and one launch, with no map concat and no table in device
memory. K1 and K3 still run ``prep_indices`` / ``prep_indices_bwd`` in
torch and hand their kernels the row starts and coefficients.
"""
from __future__ import annotations

import torch

from kgdet_tpu_torch.ops import _build
from kgdet_tpu_torch.ops.deform import bilinear_gather, pad_min2, \
    prep_indices, prep_indices_bwd


def deform_conv_fused_ref(feat, pos_yx, weight):
    """Plain version: gather the columns, then contract.
    (B,H,W,C), (B,P,K,2), (K,C,F) -> (B,P,F) in feat's dtype."""
    cols = bilinear_gather(feat, pos_yx)
    return torch.einsum('bpkc,kcf->bpf', cols, weight.to(feat.dtype))


def deform_conv_fused(feat, pos_yx, weight, plain: bool = False):
    """out[b,p,:] = sum_k sum_c bilinear(feat[b], pos[b,p,k])[c] *
    weight[k,c,:]. feat (B,H,W,C) f32|bf16, pos_yx (B,P,K,2) absolute
    (y, x), weight (K,C,F). Returns (B,P,F) in feat's dtype.

    When no gradient is wanted, kernel K1: on CUDA the sampled columns never
    reach device memory. Under differentiation, the autograd Function over
    the column gather (K6) and the sampling backward (K3), which keeps the
    columns for the weight gradient. ``plain`` runs the kernels' plain
    versions instead, whatever the device."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (feat, pos_yx, weight)):
        return _FusedConvGrad.apply(feat, pos_yx, weight, plain)
    if plain or feat.device.type == 'cpu':
        return deform_conv_fused_ref(feat, pos_yx, weight)
    feat = pad_min2(feat).contiguous()
    B, H, W, C = feat.shape
    P, K = pos_yx.shape[1], pos_yx.shape[2]
    if pos_yx.shape != (B, P, K, 2) or weight.shape[:2] != (K, C):
        raise ValueError(f'shape mismatch: feat {tuple(feat.shape)}, pos '
                         f'{tuple(pos_yx.shape)}, weight '
                         f'{tuple(weight.shape)}')
    Fo = weight.shape[2]
    starts, w4 = prep_indices(pos_yx.float(), H, W)
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


# ------------------------------------------------- K2 and K6: column gathers
def _f32_positions(pos_yx):
    """The gather kernels read contiguous f32 positions; position math runs
    in f32 whatever the input dtype, as in ``prep_indices``."""
    if pos_yx.dtype != torch.float32:
        pos_yx = pos_yx.float()
    return pos_yx.contiguous()


def _split_views(buf, B, P, C, taps):
    """The 2 * len(taps) column tensors inside one flat buffer of
    B*P*sum(taps)*2C elements: [(cls (B,P,t,C), pts (B,P,t,C)), ...],
    column-major, branch-minor."""
    cols, lo = [], 0
    for t in taps:
        n = B * P * t * C
        cols.append((buf[lo:lo + n].view(B, P, t, C),
                     buf[lo + n:lo + 2 * n].view(B, P, t, C)))
        lo += 2 * n
    return cols


def _split_table(taps, B, P, C):
    """``_split_views``'s layout as the kernel takes it, by value: per column
    its first tap, its tap count and the element offsets of its cls and pts
    tensors in the buffer."""
    table = _build.ColumnTable(n=len(taps))
    first = lo = 0
    for i, t in enumerate(taps):
        n = B * P * t * C
        table.first[i], table.taps[i] = first, t
        table.off[0][i], table.off[1][i] = lo, lo + n
        first += t
        lo += 2 * n
    return table


def deform_sample_split_ref(cls_feat, pts_feat, pos_yx, taps):
    """Plain version: one bilinear gather over the channel concat, sliced
    per column and branch."""
    C = cls_feat.shape[-1]
    samples = bilinear_gather(torch.cat([cls_feat, pts_feat], dim=-1), pos_yx)
    cols, lo = [], 0
    for t in taps:
        col = samples[:, :, lo:lo + t]
        lo += t
        cols.append((col[..., :C], col[..., C:]))
    return cols


def deform_sample_split(cls_feat, pts_feat, pos_yx, taps):
    """Sample both branch maps at shared taps, outputs split per column.

    cls_feat/pts_feat (B,H,W,C) f32|bf16; pos_yx (B,P,K,2) absolute (y, x)
    with K == sum(taps); taps: 1 to 8 columns (the kernel's by-value table
    holds ``_build.MAX_COLUMNS``) of at least one tap, on either device.
    Returns [(cls (B,P,t,C), pts (B,P,t,C)), ...] in the maps' dtype; on
    CUDA the tensors are views of one buffer that the kernel writes once."""
    taps = tuple(int(t) for t in taps)
    if not 1 <= len(taps) <= _build.MAX_COLUMNS or min(taps) < 1:
        raise ValueError(f'the split gather takes 1 to {_build.MAX_COLUMNS} '
                         f'columns of at least one tap, got {taps}')
    B, P, K = pos_yx.shape[:3]
    if cls_feat.shape != pts_feat.shape or cls_feat.dtype != pts_feat.dtype \
            or pos_yx.shape != (B, P, K, 2) or K != sum(taps) \
            or cls_feat.shape[0] != B:
        raise ValueError(f'shape mismatch: cls {tuple(cls_feat.shape)}, pts '
                         f'{tuple(pts_feat.shape)}, pos '
                         f'{tuple(pos_yx.shape)}, taps {taps}')
    if cls_feat.device.type == 'cpu':
        return deform_sample_split_ref(cls_feat, pts_feat, pos_yx, taps)
    cls_feat = pad_min2(cls_feat).contiguous()
    pts_feat = pad_min2(pts_feat).contiguous()
    _, H, W, C = cls_feat.shape
    pos_yx = _f32_positions(pos_yx)
    out = torch.empty(B * P * K * 2 * C, dtype=cls_feat.dtype,
                      device=cls_feat.device)
    if out.numel() == 0:            # no tap to sample: nothing to launch
        return _split_views(out, B, P, C, taps)
    _build.require_cuda(cls_feat, pts_feat, pos_yx, out)
    lib = _build.load('deform_split')
    rc = lib.kgdet_deform_split(
        cls_feat.data_ptr(), pts_feat.data_ptr(), pos_yx.data_ptr(),
        out.data_ptr(), _split_table(taps, B, P, C), B, H, W, C, P, K,
        _build.vec_ok(C, cls_feat, pts_feat, out),
        _build.dtype_code(cls_feat), _build.stream_ptr(out.device))
    _build.check(rc, 'deform_split')
    deform_sample_split.launches += 1
    return _split_views(out, B, P, C, taps)


deform_sample_split.launches = 0


# ------------------------------------------------------ K3: sampling backward
def deform_sample_bwd_ref(feat, pos_yx, g):
    """Plain version, from the same coefficients as the kernel
    (``prep_indices_bwd``): a scatter-add of w * g over the four corners in
    >= f32, and the position gradient as dot products of g with the
    u- and v-weighted corners."""
    H0, W0 = feat.shape[1], feat.shape[2]
    feat = pad_min2(feat)
    B, H, W, C = feat.shape
    P, K = pos_yx.shape[1], pos_yx.shape[2]
    starts, wd12 = prep_indices_bwd(pos_yx, H, W)
    acc = torch.promote_types(feat.dtype, torch.float32)
    flat = feat.reshape(B, H * W, C)
    starts = starts.reshape(B, P * K, 2).long()
    wd = wd12.reshape(B, P * K, 12).to(acc)
    g2 = g.reshape(B, P * K, C).to(acc)
    gfeat = torch.zeros((B, H * W, C), dtype=acc, device=feat.device)
    gy = torch.zeros((B, P * K), dtype=acc, device=feat.device)
    gx = torch.zeros_like(gy)
    rows = (starts[..., 0], starts[..., 0] + 1,
            starts[..., 1], starts[..., 1] + 1)
    for i, r in enumerate(rows):
        idx = r[..., None].expand(-1, -1, C)
        gfeat.scatter_add_(1, idx, g2 * wd[..., i:i + 1])
        dot = (torch.gather(flat, 1, idx).to(acc) * g2).sum(-1)
        gy += wd[..., 4 + i] * dot
        gx += wd[..., 8 + i] * dot
    grad_feat = gfeat.reshape(B, H, W, C)[:, :H0, :W0].to(feat.dtype)
    grad_pos = torch.stack([gy, gx], dim=-1).reshape(B, P, K, 2)
    return grad_feat, grad_pos.to(pos_yx.dtype)


def deform_sample_bwd(feat, pos_yx, g):
    """Backward of ``bilinear_gather(feat, pos_yx)`` for a cotangent g.

    feat (B,H,W,C) f32|bf16; pos_yx (B,P,K,2); g (B,P,K,C) in feat's dtype.
    Returns grad_feat (B,H,W,C), summed in f32 and cast to feat's dtype, and
    grad_pos (B,P,K,2) in pos_yx's dtype. On CUDA the scatter uses f32
    atomics, so grad_feat's sums are taken in an order that changes from run
    to run."""
    B, P, K = pos_yx.shape[:3]
    if feat.shape[0] != B or pos_yx.shape != (B, P, K, 2) \
            or g.shape != (B, P, K, feat.shape[-1]) or g.dtype != feat.dtype:
        raise ValueError(f'shape mismatch: feat {tuple(feat.shape)}, pos '
                         f'{tuple(pos_yx.shape)}, g {tuple(g.shape)} '
                         f'{g.dtype} vs {feat.dtype}')
    if feat.device.type == 'cpu':
        return deform_sample_bwd_ref(feat, pos_yx, g)
    H0, W0 = feat.shape[1], feat.shape[2]
    feat = pad_min2(feat).contiguous()
    _, H, W, C = feat.shape
    g = g.contiguous()
    starts, wd12 = prep_indices_bwd(pos_yx.float(), H, W)
    gfeat = torch.zeros((B, H, W, C), dtype=torch.float32, device=feat.device)
    gpos = torch.empty((B, P, K, 2), dtype=torch.float32, device=feat.device)
    _build.require_cuda(feat, starts, wd12, g, gfeat, gpos)
    lib = _build.load('deform_bwd')
    rc = lib.kgdet_deform_bwd(
        feat.data_ptr(), starts.data_ptr(), wd12.data_ptr(), g.data_ptr(),
        gfeat.data_ptr(), gpos.data_ptr(), B, H * W, C, P, K,
        _build.vec_ok(C, feat, g, gfeat), _build.dtype_code(feat),
        _build.stream_ptr(feat.device))
    _build.check(rc, 'deform_bwd')
    deform_sample_bwd.launches += 1
    return gfeat[:, :H0, :W0].to(feat.dtype), gpos.to(pos_yx.dtype)


deform_sample_bwd.launches = 0


# --------------------------------------------------- K6: one-map column gather
deform_sample_cols_ref = bilinear_gather


def deform_sample_cols(feat, pos_yx):
    """The bilinear columns of one map: feat (B,H,W,C) f32|bf16, pos_yx
    (B,P,K,2) absolute (y, x) -> (B,P,K,C) in feat's dtype; out-of-bounds
    corners weigh 0."""
    if feat.device.type == 'cpu':
        return deform_sample_cols_ref(feat, pos_yx)
    feat = pad_min2(feat).contiguous()
    B, H, W, C = feat.shape
    P, K = pos_yx.shape[1], pos_yx.shape[2]
    if pos_yx.shape != (B, P, K, 2):
        raise ValueError(f'shape mismatch: feat {tuple(feat.shape)}, pos '
                         f'{tuple(pos_yx.shape)}')
    pos_yx = _f32_positions(pos_yx)
    out = torch.empty((B, P, K, C), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:            # no tap to sample: nothing to launch
        return out
    _build.require_cuda(feat, pos_yx, out)
    lib = _build.load('deform_sample')
    rc = lib.kgdet_deform_sample(
        feat.data_ptr(), pos_yx.data_ptr(), out.data_ptr(), B, H, W, C, P, K,
        _build.vec_ok(C, feat, out), _build.dtype_code(feat),
        _build.stream_ptr(feat.device))
    _build.check(rc, 'deform_sample')
    deform_sample_cols.launches += 1
    return out


deform_sample_cols.launches = 0


class _SampleGrad(torch.autograd.Function):
    """Column gather with a kernel on both sides (``deform_sample_hybrid``
    of the JAX package): K6 forward, K3 backward. ``plain`` selects their
    plain versions."""

    @staticmethod
    def forward(ctx, feat, pos_yx, plain):
        ctx.plain = plain
        ctx.save_for_backward(feat, pos_yx)
        sample = deform_sample_cols_ref if plain else deform_sample_cols
        return sample(feat, pos_yx)

    @staticmethod
    def backward(ctx, g):
        feat, pos_yx = ctx.saved_tensors
        bwd = deform_sample_bwd_ref if ctx.plain else deform_sample_bwd
        grad_feat, grad_pos = bwd(feat, pos_yx, g.to(feat.dtype).contiguous())
        return grad_feat, grad_pos, None


def deform_sample_hybrid(feat, pos_yx, plain: bool = False):
    """Differentiable ``deform_sample_cols``: the gradients of the map and
    of the positions come from the sampling backward (K3)."""
    return _SampleGrad.apply(feat, pos_yx, plain)


class _FusedConvGrad(torch.autograd.Function):
    """The differentiated path of ``deform_conv_fused`` (the custom_vjp
    rules ``_fused_fwd`` / ``_fused_bwd`` of the JAX package).

    Forward: the columns once (K6), one contraction accumulated in f32 and
    rounded to the map's dtype; the columns are saved. Backward: the column
    cotangent g @ w^T rounded to the map's dtype, ONE sampling backward
    (K3), and the weight gradient cols^T @ g from the saved columns, cast to
    the weight's dtype. The contractions are library matmuls, as the JAX
    package leaves them to XLA. ``plain`` selects the plain versions of K6
    and K3 (the comparison model)."""

    @staticmethod
    def forward(ctx, feat, pos_yx, weight, plain):
        sample = deform_sample_cols_ref if plain else deform_sample_cols
        cols = sample(feat, pos_yx)
        B, P, K, C = cols.shape
        w = weight.to(feat.dtype).reshape(K * C, -1)
        ctx.plain, ctx.weight_dtype = plain, weight.dtype
        ctx.save_for_backward(feat, pos_yx, w, cols)
        return (cols.reshape(B * P, K * C) @ w).view(B, P, -1)

    @staticmethod
    def backward(ctx, g):
        feat, pos_yx, w, cols = ctx.saved_tensors
        B, P, K, C = cols.shape
        gc = g.reshape(B * P, -1).to(feat.dtype)
        g_w = (cols.reshape(B * P, K * C).t() @ gc).view(K, C, -1) \
            .to(ctx.weight_dtype)
        g_cols = (gc @ w.t()).view(B, P, K, C)
        bwd = deform_sample_bwd_ref if ctx.plain else deform_sample_bwd
        grad_feat, grad_pos = bwd(feat, pos_yx, g_cols)
        return grad_feat, grad_pos, g_w, None


# ---------------------------------------------- the cascade block's dual path
class _ColumnsDualGrad(torch.autograd.Function):
    """The differentiated path of ``deform_columns_dual`` (the custom_vjp
    rules ``_columns_dual_fwd`` / ``_columns_dual_bwd`` of the JAX package).

    Forward: one split gather of all taps (K2), then one contraction per
    (column, branch), accumulated in f32 and rounded to the maps' dtype; the
    columns are saved. Backward: weight gradients from the saved columns;
    the column cotangents of every (column, branch), rounded to the maps'
    dtype, assembled into one (B, P, K, 2C) tensor; then ONE sampling
    backward (K3) over the cls|pts concat. The contractions are library
    matmuls, as the JAX package leaves them to XLA. ``plain`` selects the
    plain versions of K2 and K3 (the comparison model)."""

    @staticmethod
    def forward(ctx, cls_feat, pts_feat, pos_yx, taps, plain, *weights):
        split = deform_sample_split_ref if plain else deform_sample_split
        cols = split(cls_feat, pts_feat, pos_yx, taps)
        B, P = pos_yx.shape[:2]
        n = len(taps)
        dt = cls_feat.dtype
        ctx.weight_dtypes = [w.dtype for w in weights]
        weights = [w.to(dt) for w in weights]

        def contract(col, w):       # (B,P,t,C) x (t,C,F) -> (B,P,F)
            return (col.reshape(B * P, -1) @ w.reshape(-1, w.shape[-1])) \
                .view(B, P, -1)

        cls_cat = torch.cat([contract(cols[i][0], weights[i])
                             for i in range(n)], dim=-1)
        kpt_cat = torch.cat([contract(cols[i][1], weights[n + i])
                             for i in range(n)], dim=-1)
        ctx.taps, ctx.plain = taps, plain
        ctx.save_for_backward(cls_feat, pts_feat, pos_yx, *weights,
                              *[c for pair in cols for c in pair])
        return cls_cat, kpt_cat

    @staticmethod
    def backward(ctx, g_cls, g_pts):
        taps, n = ctx.taps, len(ctx.taps)
        cls_feat, pts_feat, pos_yx = ctx.saved_tensors[:3]
        weights = ctx.saved_tensors[3:3 + 2 * n]
        cols = ctx.saved_tensors[3 + 2 * n:]
        B, P, K = pos_yx.shape[:3]
        C = cls_feat.shape[-1]
        F = weights[0].shape[-1]
        dt = cls_feat.dtype
        g_all = torch.empty((B, P, K, 2 * C), dtype=dt,
                            device=cls_feat.device)
        gw = [None] * (2 * n)
        lo = 0
        for ci, t in enumerate(taps):
            for br, g in enumerate((g_cls, g_pts)):
                gc = g[..., ci * F:(ci + 1) * F].reshape(B * P, F).to(dt)
                col = cols[2 * ci + br].reshape(B * P, t * C)
                w = weights[br * n + ci]
                gw[br * n + ci] = (col.t() @ gc).view(t, C, F) \
                    .to(ctx.weight_dtypes[br * n + ci])
                g_all[:, :, lo:lo + t, br * C:(br + 1) * C] = \
                    (gc @ w.reshape(t * C, F).t()).view(B, P, t, C)
            lo += t
        bwd = deform_sample_bwd_ref if ctx.plain else deform_sample_bwd
        grad_cat, grad_pos = bwd(torch.cat([cls_feat, pts_feat], dim=-1),
                                 pos_yx, g_all)
        return (grad_cat[..., :C], grad_cat[..., C:], grad_pos, None, None,
                *gw)


def deform_columns_dual(cls_feat, pts_feat, pos_yx, w_cls, w_pts, taps,
                        plain: bool = False):
    """The cascade block's multi-column, two-branch deformable convs.

    cls_feat/pts_feat: (B, H, W, C); pos_yx: (B, P, K, 2), K == sum(taps);
    w_cls/w_pts: sequences of (t, C, F) per column. Returns (cls_cat,
    kpt_cat), each (B, P, len(taps)*F), pre-activation, column-major.

    When no gradient is wanted (inference), one fused gather + contraction
    (K1) per (column, branch): the columns never reach device memory. Under
    differentiation, the autograd Function over the shared split gather (K2)
    and the one sampling backward (K3). ``plain`` runs the kernels' plain
    versions instead, whatever the device."""
    taps = tuple(int(t) for t in taps)
    operands = (cls_feat, pts_feat, pos_yx, *w_cls, *w_pts)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _ColumnsDualGrad.apply(cls_feat, pts_feat, pos_yx, taps,
                                      plain, *w_cls, *w_pts)
    conv = deform_conv_fused_ref if plain else deform_conv_fused
    cls_out, pts_out = [], []
    lo = 0
    for ci, t in enumerate(taps):
        pcol = pos_yx[:, :, lo:lo + t]
        lo += t
        cls_out.append(conv(cls_feat, pcol, w_cls[ci]))
        pts_out.append(conv(pts_feat, pcol, w_pts[ci]))
    return torch.cat(cls_out, dim=-1), torch.cat(pts_out, dim=-1)
