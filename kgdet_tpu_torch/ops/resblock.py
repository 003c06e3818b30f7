"""Frozen ResNet bottleneck math with FrozenBatchNorm folded into the convs.

Port of kgdet_tpu/ops/pallas_resblock.py: ``fold_bn``,
``bottleneck_reference`` and K8 ``fused_bottleneck`` (csrc/resblock.cu), which
replaces the TPU kernel ``fused_bottleneck`` (kernel ``_kernel``): one frozen
stride-1 bottleneck per launch at any width, the per-block route of a frozen
layer1. ``bottleneck_reference`` is its plain version, and also that of
kernel K5 (ops/stem_kernels.py::frozen_bottleneck, width 64 only, inside the
whole-prefix chain).

On a CPU tensor ``fused_bottleneck`` runs the plain version; on a CUDA tensor
it launches its kernel or raises. There is no gradient: the block is frozen.

Weight convention (as in the JAX reference): w1 (Cin, width), w2
(3, 3, width, width) HWIO, w3 (width, Cout), wd (Cin, Cout) or None; f32
biases. Activations are NHWC (B, H, W, C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from kgdet_tpu_torch.ops import _build

# dynamic shared memory a block can ask for on the H100 (227 KB)
MAX_SHARED_BYTES = 232448


def fold_bn(kernel, scale, bias, mean, var, eps=1e-5):
    """Fold a FrozenBatchNorm that FOLLOWS a conv into the conv:
    bn(conv(x, K)) == conv(x, K * inv) + (bias - mean * inv) with
    inv = scale / sqrt(var + eps). kernel: (..., Cout). Returns f32
    (folded_kernel, folded_bias)."""
    inv = (scale * torch.rsqrt(var + eps)).float()
    return kernel.float() * inv, bias - mean * inv


def _conv(x, w_oihw, padding=0):
    """NHWC in, NHWC-shaped (channels_last) out, in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw.to(x.dtype), padding=padding)
    return y.permute(0, 2, 3, 1)


def bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """relu(conv1x1 -> relu -> conv3x3 -> relu -> conv1x1 + identity or
    downsample) with folded weights; intermediates rounded to x's dtype."""
    dt = x.dtype
    a = torch.relu(_conv(x, w1.t()[:, :, None, None]).float() + b1).to(dt)
    b_ = torch.relu(_conv(a, w2.permute(3, 2, 0, 1), padding=1).float()
                    + b2).to(dt)
    c = _conv(b_, w3.t()[:, :, None, None]).float() + b3
    if wd is not None:
        ident = _conv(x, wd.t()[:, :, None, None]).float() + bd
    else:
        ident = x.float()
    return torch.relu(c + ident).to(dt)


def fused_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """One frozen stride-1 bottleneck block in one launch, conv1's and
    conv2's activations in shared memory.

    x (B,H,W,cin) f32|bf16; w1 (cin,width); w2 (3,3,width,width) HWIO; w3
    (width,cout); wd (cin,cout) or None (then cin == cout and the identity is
    x itself); b* f32 biases with BN folded (``fold_bn``). Returns
    (B,H,W,cout) in x's dtype. cin and width are multiples of 8, as for the
    TPU kernel; any H, W and cout. Raises on a width whose tiles do not fit a
    block's shared memory."""
    if x.device.type == 'cpu':
        return bottleneck_reference(x, w1, b1, w2, b2, w3, b3, wd, bd)
    B, H, W, cin = x.shape
    width, cout = w1.shape[-1], w3.shape[-1]
    has_ds = wd is not None
    if tuple(w1.shape) != (cin, width) \
            or tuple(w2.shape) != (3, 3, width, width) \
            or tuple(w3.shape) != (width, cout) or cin % 8 or width % 8 \
            or (has_ds and tuple(wd.shape) != (cin, cout)) \
            or (not has_ds and cin != cout):
        raise ValueError(
            f'fused_bottleneck takes cin and width in multiples of 8 and '
            f'cin == cout without a downsample, got x {tuple(x.shape)}, w1 '
            f'{tuple(w1.shape)}, w2 {tuple(w2.shape)}, w3 '
            f'{tuple(w3.shape)}, downsample {has_ds}')
    lib = _build.load('resblock')
    need = lib.kgdet_fused_bottleneck_smem(width)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f'fused_bottleneck: width {width} needs {need} bytes of shared '
            f'memory a block, the card has {MAX_SHARED_BYTES}')
    dt = x.dtype
    x = x.contiguous()
    ws = [w.to(dt).contiguous() for w in (w1, w2, w3)]
    bs = [v.float().contiguous() for v in (b1, b2, b3)]
    ds = ([wd.to(dt).contiguous(), bd.float().contiguous()] if has_ds
          else [])
    out = torch.empty((B, H, W, cout), dtype=dt, device=x.device)
    _build.require_cuda(x, *ws, *bs, *ds, out)
    rc = lib.kgdet_fused_bottleneck(
        x.data_ptr(), ws[0].data_ptr(), bs[0].data_ptr(), ws[1].data_ptr(),
        bs[1].data_ptr(), ws[2].data_ptr(), bs[2].data_ptr(),
        ds[0].data_ptr() if has_ds else None,
        ds[1].data_ptr() if has_ds else None, out.data_ptr(),
        B, H, W, cin, width, cout, _build.dtype_code(x),
        _build.stream_ptr(x.device))
    _build.check(rc, 'fused_bottleneck')
    fused_bottleneck.launches += 1
    return out


fused_bottleneck.launches = 0
