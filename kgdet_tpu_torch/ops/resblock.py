"""Frozen ResNet bottleneck math with FrozenBatchNorm folded into the convs.

Port of kgdet_tpu/ops/pallas_resblock.py: ``fold_bn``,
``bottleneck_reference`` and K8 ``fused_bottleneck`` (csrc/resblock.cu), which
replaces the TPU kernel ``fused_bottleneck`` (kernel ``_kernel``): one frozen
stride-1 bottleneck per launch at any width, the per-block route of a frozen
layer1. ``bottleneck_reference`` is its plain version, and also that of
kernel K5 (ops/stem_kernels.py::frozen_bottleneck, width 64 only, inside the
whole-prefix chain). In bf16 K8 and K5 run one tensor-core body
(csrc/prefix_mma.cuh); f32 runs an FMA body.

On a CPU tensor ``fused_bottleneck`` runs the plain version; on a CUDA tensor
it launches its kernel or raises. There is no gradient: the block is frozen.

Two levels of entry, as for K5: ``fused_bottleneck`` takes folded weights
and prepares them on every call; ``fused_bottleneck_prepared`` takes what
``prepare_resblock`` made once (the kernels' layout in the compute dtype,
which K5 shares), so a caller that keeps those
(models/resnet.py::ResNet.prefix_weights) puts one kernel and nothing else
on the device a call.

Weight convention (as in the JAX reference): w1 (Cin, width), w2
(3, 3, width, width) HWIO, w3 (width, Cout), wd (Cin, Cout) or None; f32
biases. Activations are NHWC (B, H, W, C).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from kgdet_tpu_torch.ops import _build
from kgdet_tpu_torch.ops.kernel_cost import bottleneck_cost, counted

# dynamic shared memory a block can ask for on the H100 (227 KB)
MAX_SHARED_BYTES = 232448
BLOCK_KEYS = ('w1', 'b1', 'w2', 'b2', 'w3', 'b3', 'wd', 'bd')


def bn_scale_shift(scale, bias, mean, var, eps=1e-5):
    """A FrozenBatchNorm as a per-channel affine: bn(y) == y * inv + shift
    with inv = scale / sqrt(var + eps) and shift = bias - mean * inv.
    Returns f32 (inv, shift)."""
    inv = (scale * torch.rsqrt(var + eps)).float()
    return inv, bias - mean * inv


def fold_bn(kernel, scale, bias, mean, var, eps=1e-5):
    """Fold a FrozenBatchNorm that FOLLOWS a conv into the conv:
    bn(conv(x, K)) == conv(x, K * inv) + shift (``bn_scale_shift``).
    kernel: (..., Cout). Returns f32 (folded_kernel, folded_bias)."""
    inv, shift = bn_scale_shift(scale, bias, mean, var, eps)
    return kernel.float() * inv, shift


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


def prepare_resblock(blk, dtype):
    """K8's (and K5's) weights for inputs of ``dtype`` from a dict of folded
    weights {w1, b1, w2, b2, w3, b3, wd?, bd?}: the tuple (w1, b1, ..., wd,
    bd), weights in ``dtype`` and contiguous, which is the kernels' layout
    (w1 [ci][co], w2 (3,3,width,width) [tap][ci][co], w3 and wd [ci][co]),
    biases f32, wd and bd None without a downsample."""
    return tuple(None if blk.get(k) is None else
                 blk[k].to(dtype if k[0] == 'w' else torch.float32)
                 .contiguous() for k in BLOCK_KEYS)


@counted('K8 fused_bottleneck', bottleneck_cost)
def fused_bottleneck_prepared(x, blk):
    """fused_bottleneck on weights from ``prepare_resblock(.., x.dtype)``:
    one K8 launch. Raises on shapes the kernel does not take and on a width
    whose tiles fit neither body's shared memory."""
    if x.device.type == 'cpu':
        return bottleneck_reference(x, *blk)
    w1, b1, w2, b2, w3, b3, wd, bd = blk
    B, H, W, cin = x.shape
    width, cout = w1.shape[-1], w3.shape[-1]
    has_ds = wd is not None
    if tuple(w1.shape) != (cin, width) \
            or tuple(w2.shape) != (3, 3, width, width) \
            or tuple(w3.shape) != (width, cout) or cin % 8 or width % 8 \
            or (has_ds and tuple(wd.shape) != (cin, cout)) \
            or (not has_ds and cin != cout) \
            or any(w.dtype != x.dtype for w in (w1, w2, w3)):
        raise ValueError(
            f'fused_bottleneck takes cin and width in multiples of 8, '
            f'cin == cout without a downsample and weights prepared for its '
            f'dtype, got x {tuple(x.shape)} {x.dtype}, w1 {tuple(w1.shape)} '
            f'{w1.dtype}, w2 {tuple(w2.shape)}, w3 {tuple(w3.shape)}, '
            f'downsample {has_ds}')
    code = _build.dtype_code(x)
    lib = _build.load('resblock')
    need = lib.kgdet_fused_bottleneck_smem(width, code)
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f'fused_bottleneck: width {width} needs {need} bytes of shared '
            f'memory a block, the card has {MAX_SHARED_BYTES}')
    x = x.contiguous()
    weights = [w1, w2, w3] + ([wd] if has_ds else [])
    biases = [b1, b2, b3] + ([bd] if has_ds else [])
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=x.device)
    _build.require_cuda(x, *weights, *biases, out)
    rc = lib.kgdet_fused_bottleneck(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
        wd.data_ptr() if has_ds else None, bd.data_ptr() if has_ds else None,
        out.data_ptr(), B, H, W, cin, width, cout, code,
        _build.stream_ptr(x.device))
    _build.check(rc, 'fused_bottleneck')
    fused_bottleneck.launches += 1
    return out


@counted('K8 fused_bottleneck', bottleneck_cost)
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
    blk = dict(zip(BLOCK_KEYS, (w1, b1, w2, b2, w3, b3, wd, bd)))
    return fused_bottleneck_prepared(x, prepare_resblock(blk, x.dtype))


fused_bottleneck.launches = 0
