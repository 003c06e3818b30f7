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

Each wrapper launches its kernel, or raises, where ``ops.runs_kernel``
says so (a CUDA tensor outside ``ops.plain_kernels()``), and runs its plain
version (``*_ref``) otherwise. Every kernel takes the absolute
positions themselves and does the index math of ``ops/deform.py::
prep_indices`` / ``prep_indices_bwd`` inside (csrc/tap_coeffs.h, held
against both bit for bit by tests/test_torch_kernels.py): a call of K1, K2
or K6 is argument checks, one ``torch.empty`` and one launch, with no map
concat and no table in device memory; a call of K3 is one zeroed f32
buffer, one launch and the cast of the map's gradient. ``prep_indices*``
feed only the plain versions.
"""
from __future__ import annotations

import torch

from kgdet_tpu_torch.ops import _build, plain_kernels, runs_kernel
from kgdet_tpu_torch.ops.deform import bilinear_gather, pad_min2, \
    prep_indices_bwd
from kgdet_tpu_torch.ops.kernel_cost import counted, nbytes, sample_ops


def _f32_positions(pos_yx):
    """The kernels read contiguous f32 positions; position math runs in f32
    whatever the input dtype, as in ``prep_indices``."""
    if pos_yx.dtype != torch.float32:
        pos_yx = pos_yx.float()
    return pos_yx.contiguous()


def deform_conv_fused_ref(feat, pos_yx, weight):
    """Plain version: gather the columns, then contract.
    (B,H,W,C), (B,P,K,2), (K,C,F) -> (B,P,F) in feat's dtype."""
    cols = bilinear_gather(feat, pos_yx)
    return torch.einsum('bpkc,kcf->bpf', cols, weight.to(feat.dtype))


def _k1_cost(feat, pos_yx, weight):
    """The contraction, 2 a multiply-add, and the lerp of every sampled
    value; the map, f32 positions, the weight and the output in the map's
    dtype."""
    B, P, K = pos_yx.shape[:3]
    C, Fo, e = feat.shape[-1], weight.shape[-1], feat.element_size()
    return (2 * B * P * K * C * Fo + sample_ops(B * P * K * C),
            nbytes(feat) + 4 * pos_yx.numel() + e * weight.numel()
            + e * B * P * Fo)


@counted('K1 deform_conv_fused', _k1_cost)
def deform_conv_fused(feat, pos_yx, weight):
    """out[b,p,:] = sum_k sum_c bilinear(feat[b], pos[b,p,k])[c] *
    weight[k,c,:]. feat (B,H,W,C) f32|bf16, pos_yx (B,P,K,2) absolute
    (y, x), weight (K,C,F). Returns (B,P,F) in feat's dtype.

    When no gradient is wanted, kernel K1: on CUDA the sampled columns never
    reach device memory, and a bf16 map's product runs on the tensor cores
    (f32 maps keep full-f32 arithmetic). A weight that is already contiguous
    in feat's dtype is passed as it is. Under differentiation, the autograd
    Function over the column gather (K6) and the sampling backward (K3),
    which keeps the columns for the weight gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (feat, pos_yx, weight)):
        return _FusedConvGrad.apply(feat, pos_yx, weight)
    if not runs_kernel(feat):
        return deform_conv_fused_ref(feat, pos_yx, weight)
    feat = pad_min2(feat).contiguous()
    B, H, W, C = feat.shape
    P, K = pos_yx.shape[1], pos_yx.shape[2]
    if pos_yx.shape != (B, P, K, 2) or weight.shape[:2] != (K, C):
        raise ValueError(f'shape mismatch: feat {tuple(feat.shape)}, pos '
                         f'{tuple(pos_yx.shape)}, weight '
                         f'{tuple(weight.shape)}')
    Fo = weight.shape[2]
    pos_yx = _f32_positions(pos_yx)
    if weight.dtype != feat.dtype:
        weight = weight.to(feat.dtype)
    weight = weight.contiguous()
    out = torch.empty((B, P, Fo), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:            # no pixel or no channel: nothing to launch
        return out
    _build.require_cuda(feat, pos_yx, weight, out)
    lib = _build.load('deform_fused')
    rc = lib.kgdet_deform_fused(
        feat.data_ptr(), pos_yx.data_ptr(), weight.data_ptr(),
        out.data_ptr(), B, H, W, C, P, K, Fo,
        _build.vec_ok(C, feat, weight), _build.dtype_code(feat),
        _build.stream_ptr(feat.device))
    _build.check(rc, 'deform_fused')
    deform_conv_fused.launches += 1
    return out


deform_conv_fused.launches = 0


# ------------------------------------------------- K2 and K6: column gathers
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


def _k2_cost(cls_feat, pts_feat, pos_yx, taps):
    """Every tap sampled on both maps; both maps, f32 positions, and the
    columns written once."""
    n = pos_yx.shape[:3].numel() * 2 * cls_feat.shape[-1]
    return (sample_ops(n), nbytes(cls_feat, pts_feat) + 4 * pos_yx.numel()
            + n * cls_feat.element_size())


@counted('K2 deform_sample_split', _k2_cost)
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
    if not runs_kernel(cls_feat):
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


def _k3_cost(feat, pos_yx, g):
    """A sampled value's scatter (8 operations) and its position dot
    products (18); the map, f32 positions and the cotangent read, the map's
    and the positions' gradients written."""
    return 26 * g.numel(), nbytes(feat, g, feat) + 8 * pos_yx.numel()


@counted('K3 deform_sample_bwd', _k3_cost)
def deform_sample_bwd(feat, pos_yx, g):
    """Backward of ``bilinear_gather(feat, pos_yx)`` for a cotangent g.

    feat (B,H,W,C) f32|bf16; pos_yx (B,P,K,2); g (B,P,K,C) in feat's dtype.
    Returns grad_feat (B,H,W,C), summed in f32 and cast to feat's dtype, and
    grad_pos (B,P,K,2) in pos_yx's dtype. On CUDA both are summed with f32
    atomics (shared-memory ones for grad_feat where the map's rows fit, see
    csrc/deform_bwd.cu), in an order that changes from run to run; the two
    come out of one zeroed f32 buffer, of which grad_pos is a view."""
    B, P, K = pos_yx.shape[:3]
    if feat.shape[0] != B or pos_yx.shape != (B, P, K, 2) \
            or g.shape != (B, P, K, feat.shape[-1]) or g.dtype != feat.dtype:
        raise ValueError(f'shape mismatch: feat {tuple(feat.shape)}, pos '
                         f'{tuple(pos_yx.shape)}, g {tuple(g.shape)} '
                         f'{g.dtype} vs {feat.dtype}')
    if not runs_kernel(feat):
        return deform_sample_bwd_ref(feat, pos_yx, g)
    H0, W0 = feat.shape[1], feat.shape[2]
    feat = pad_min2(feat).contiguous()
    _, H, W, C = feat.shape
    g = g.contiguous()
    pos32 = _f32_positions(pos_yx)
    # one fill for both outputs; an even element count keeps grad_pos on the
    # 8-byte boundary of the kernel's float2 adds
    n_feat = B * H * W * C
    n_feat += n_feat % 2
    acc = torch.zeros(n_feat + B * P * K * 2, dtype=torch.float32,
                      device=feat.device)
    gfeat = acc[:B * H * W * C].view(B, H, W, C)
    gpos = acc[n_feat:].view(B, P, K, 2)
    if gpos.numel() and C:
        _build.require_cuda(feat, pos32, g, acc)
        lib = _build.load('deform_bwd')
        rc = lib.kgdet_deform_bwd(
            feat.data_ptr(), pos32.data_ptr(), g.data_ptr(),
            gfeat.data_ptr(), gpos.data_ptr(), B, H, W, C, P, K,
            _build.vec_ok(C, feat, g, gfeat), _build.dtype_code(feat),
            _build.stream_ptr(feat.device))
        _build.check(rc, 'deform_bwd')
        deform_sample_bwd.launches += 1
    return gfeat[:, :H0, :W0].to(feat.dtype), gpos.to(pos_yx.dtype)


deform_sample_bwd.launches = 0


# --------------------------------------------------- K6: one-map column gather
deform_sample_cols_ref = bilinear_gather


def _k6_cost(feat, pos_yx):
    """Every tap sampled on the map; the map, f32 positions and the columns
    written once."""
    n = pos_yx.shape[:3].numel() * feat.shape[-1]
    return (sample_ops(n), nbytes(feat) + 4 * pos_yx.numel()
            + n * feat.element_size())


@counted('K6 deform_sample_cols', _k6_cost)
def deform_sample_cols(feat, pos_yx):
    """The bilinear columns of one map: feat (B,H,W,C) f32|bf16, pos_yx
    (B,P,K,2) absolute (y, x) -> (B,P,K,C) in feat's dtype; out-of-bounds
    corners weigh 0."""
    if not runs_kernel(feat):
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


def _sample_bwd(kernel, feat, pos_yx, g):
    """The sampling backward of a Function's ``backward``, on K3 or its
    plain version as ``kernel``, the forward's ``runs_kernel``, says."""
    with plain_kernels(not kernel):
        return deform_sample_bwd(feat, pos_yx, g)


class _SampleGrad(torch.autograd.Function):
    """Column gather with a kernel on both sides (``deform_sample_hybrid``
    of the JAX package): K6 forward, K3 backward."""

    @staticmethod
    def forward(ctx, feat, pos_yx):
        ctx.kernel = runs_kernel(feat)
        ctx.save_for_backward(feat, pos_yx)
        return deform_sample_cols(feat, pos_yx)

    @staticmethod
    def backward(ctx, g):
        feat, pos_yx = ctx.saved_tensors
        return _sample_bwd(ctx.kernel, feat, pos_yx,
                           g.to(feat.dtype).contiguous())


def deform_sample_hybrid(feat, pos_yx):
    """Differentiable ``deform_sample_cols``: the gradients of the map and
    of the positions come from the sampling backward (K3)."""
    return _SampleGrad.apply(feat, pos_yx)


class _FusedConvGrad(torch.autograd.Function):
    """The differentiated path of ``deform_conv_fused`` (the custom_vjp
    rules ``_fused_fwd`` / ``_fused_bwd`` of the JAX package).

    Forward: the columns once (K6), one contraction accumulated in f32 and
    rounded to the map's dtype; the columns are saved. Backward: the column
    cotangent g @ w^T rounded to the map's dtype, ONE sampling backward
    (K3), and the weight gradient cols^T @ g from the saved columns, cast to
    the weight's dtype. The contractions are library matmuls, as the JAX
    package leaves them to XLA."""

    @staticmethod
    def forward(ctx, feat, pos_yx, weight):
        cols = deform_sample_cols(feat, pos_yx)
        B, P, K, C = cols.shape
        w = weight.to(feat.dtype).reshape(K * C, -1)
        ctx.kernel, ctx.weight_dtype = runs_kernel(feat), weight.dtype
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
        grad_feat, grad_pos = _sample_bwd(ctx.kernel, feat, pos_yx, g_cols)
        return grad_feat, grad_pos, g_w


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
    matmuls, as the JAX package leaves them to XLA."""

    @staticmethod
    def forward(ctx, cls_feat, pts_feat, pos_yx, taps, *weights):
        cols = deform_sample_split(cls_feat, pts_feat, pos_yx, taps)
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
        ctx.taps, ctx.kernel = taps, runs_kernel(cls_feat)
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
        grad_cat, grad_pos = _sample_bwd(
            ctx.kernel, torch.cat([cls_feat, pts_feat], dim=-1), pos_yx,
            g_all)
        return (grad_cat[..., :C], grad_cat[..., C:], grad_pos, None, *gw)


def deform_columns_dual(cls_feat, pts_feat, pos_yx, w_cls, w_pts, taps):
    """The cascade block's multi-column, two-branch deformable convs.

    cls_feat/pts_feat: (B, H, W, C); pos_yx: (B, P, K, 2), K == sum(taps);
    w_cls/w_pts: sequences of (t, C, F) per column. Returns (cls_cat,
    kpt_cat), each (B, P, len(taps)*F), pre-activation, column-major.

    When no gradient is wanted (inference), one fused gather + contraction
    (K1) per (column, branch): the columns never reach device memory. Under
    differentiation, the autograd Function over the shared split gather (K2)
    and the one sampling backward (K3)."""
    taps = tuple(int(t) for t in taps)
    operands = (cls_feat, pts_feat, pos_yx, *w_cls, *w_pts)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _ColumnsDualGrad.apply(cls_feat, pts_feat, pos_yx, taps,
                                      *w_cls, *w_pts)
    cls_out, pts_out = [], []
    lo = 0
    for ci, t in enumerate(taps):
        pcol = pos_yx[:, :, lo:lo + t]
        lo += t
        cls_out.append(deform_conv_fused(cls_feat, pcol, w_cls[ci]))
        pts_out.append(deform_conv_fused(pts_feat, pcol, w_pts[ci]))
    return torch.cat(cls_out, dim=-1), torch.cat(pts_out, dim=-1)
