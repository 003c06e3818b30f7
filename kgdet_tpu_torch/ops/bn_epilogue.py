"""K10 ``bn_epilogue`` (csrc/bn_epilogue.cu): the epilogue of a served conv
whose FrozenBatchNorm is folded into its weight
(models/layers.py::conv_frozen_bn), in one pass in place in the conv's
output: the BN's per-channel f32 shift, then a residual identity (itself
shifted where it is a downsample's raw conv output), then the ReLU.

``bn_epilogue_ref``, its plain version, is the PyTorch chain the fold ran
before K10: ``y.add_(shift)`` (f32 sum, one rounding to y's dtype), the
identity's shift the same way, ``y + identity``, ``torch.relu``. K10 gives
the same bits, NaN and signed zeros included. It runs where
``ops.runs_kernel`` says so; ``bn_epilogue.launches`` counts its launches.

Maps are (N, C, H, W), float32 or bfloat16, channels-last: every served
trunk makes them so (the NHWC input, permuted; the frozen prefix's NHWC
output; cuDNN keeps the layout), below 2**31 elements. The kernel raises
on anything else.
"""
from __future__ import annotations

import torch

from kgdet_tpu_torch.ops import _build, runs_kernel
from kgdet_tpu_torch.ops.kernel_cost import counted, nbytes

MAX_CHANNELS = 6144     # two f32 shifts a channel in 48 KB of shared memory
MAX_ELEMENTS = 2 ** 31 - 1      # the kernel's indices are 32-bit


def _cost(y, shift, identity=None, identity_shift=None, relu=True):
    """No operation counted (an add or a max an element); the map read and
    written once, the identity and the shifts read once."""
    return 0, 2 * nbytes(y) + nbytes(identity, shift, identity_shift)


def bn_epilogue_ref(y, shift, identity=None, identity_shift=None,
                    relu=True):
    """The plain version: ``y.add_(shift)`` (f32 sum rounded once to y's
    dtype, in place), then ``y + identity``, where ``identity_shift`` first
    makes the identity ``identity + identity_shift`` rounded the same way,
    then ``torch.relu`` where asked."""
    y = y.add_(shift[:, None, None])
    if identity is not None:
        if identity_shift is not None:
            identity = (identity + identity_shift[:, None, None]).to(
                identity.dtype)
        y = y + identity
    return torch.relu(y) if relu else y


@counted('K10 bn_epilogue', _cost)
def bn_epilogue(y, shift, identity=None, identity_shift=None, relu=True):
    """``relu(round(y + shift) + identity)`` per channel of the (N, C, H, W)
    map ``y``, in place: ``shift`` (C,) f32; ``identity`` None or a map of
    y's shape and dtype, with ``identity_shift`` (C,) f32 added to it (and
    rounded) first where given; ``relu`` False leaves the ReLU out. Returns
    ``y``. Kernel K10 where ``runs_kernel(y)``, else ``bn_epilogue_ref``
    (which returns a new tensor after the shift)."""
    if not runs_kernel(y):
        return bn_epilogue_ref(y, shift, identity, identity_shift, relu)
    lib = _build.load('bn_epilogue')
    code = _build.dtype_code(y)
    C = y.shape[1] if y.dim() == 4 else 0
    maps = (y,) if identity is None else (y, identity)
    shifts = (shift,) if identity_shift is None else (shift, identity_shift)
    if not (y.device.type == 'cuda' and 0 < C <= MAX_CHANNELS
            and y.numel() <= MAX_ELEMENTS
            and (identity is not None or identity_shift is None)
            and all(m.shape == y.shape and m.dtype == y.dtype
                    and m.device == y.device
                    and m.is_contiguous(memory_format=torch.channels_last)
                    for m in maps)
            and all(s.shape == (C,) and s.dtype == torch.float32
                    and s.device == y.device and s.is_contiguous()
                    for s in shifts)):
        raise ValueError(
            'bn_epilogue takes a channels-last (N, C, H, W) CUDA map of at '
            f'most {MAX_CHANNELS} channels and {MAX_ELEMENTS} elements, an '
            'identity like it (or none; '
            'identity_shift only with one) and (C,) float32 shifts on its '
            f'device; got {tuple(y.shape)} {y.dtype} on {y.device}')
    if identity is not None and _overlap(y, identity):
        raise ValueError('bn_epilogue: identity overlaps the map it is '
                         'added into')
    if y.numel() == 0:
        return y
    vec = int(C % (16 // y.element_size()) == 0
              and all(m.data_ptr() % 16 == 0 for m in maps))
    rc = lib.kgdet_bn_epilogue(
        y.data_ptr(), identity.data_ptr() if identity is not None else None,
        shift.data_ptr(),
        identity_shift.data_ptr() if identity_shift is not None else None,
        y.numel(), C, vec, int(relu), code,
        _build.stream_ptr(y.device))
    _build.check(rc, 'bn_epilogue')
    bn_epilogue.launches += 1
    return y


bn_epilogue.launches = 0


def _overlap(a, b):
    """Whether the bytes of two dense tensors overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + nbytes(b) and b0 < a0 + nbytes(a)
