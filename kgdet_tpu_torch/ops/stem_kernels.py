"""K4 and K5: the frozen stem -> maxpool -> layer1 prefix
(csrc/stem_layer1.cu).

Port of kgdet_tpu/ops/pallas_stem.py: ``stem_pool`` replaces
``_stem_kernel`` (stem_pool_transposed) and ``frozen_bottleneck`` replaces
``_block_kernel`` (bottleneck_transposed); ``stem_layer1`` chains them like
``stem_layer1_pipeline``. The TPU's transposed interior layout has no
meaning here: activations stay NHWC.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Weights arrive with FrozenBatchNorm folded
(ops/resblock.py::fold_bn); there is no gradient, as the prefix is frozen.

Two levels of entry: ``stem_pool``, ``frozen_bottleneck`` and
``stem_layer1`` take folded weights and prepare them for the kernel on
every call; the ``*_prepared`` entries take what ``prepare_stem`` and
``prepare_block`` made (the kernels' layout in the compute dtype), so a
caller that keeps those (models/resnet.py::ResNet.prefix_weights) puts one
kernel and nothing else on the device a call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from kgdet_tpu_torch.ops import _build
from kgdet_tpu_torch.ops.resblock import BLOCK_KEYS, bottleneck_reference, \
    prepare_resblock

STEM_CH = 64
WIDTH = 64
# the bf16 stem weight's packing, csrc/prefix_index.h: depth k = ky *
# STEM_KROW + kx * 3 + ci, zero past the 21 values of a kernel row and
# past 7 rows, STEM_KPAD deep
STEM_KROW = 24
STEM_KPAD = 176


def _pool_hw(H, W):
    """Output size of the 7x7/2 pad-3 conv then the 3x3/2 pad-1 pool."""
    H2, W2 = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    return (H2 - 1) // 2 + 1, (W2 - 1) // 2 + 1


def stem_pool_ref(x, w, b):
    """Plain version of K4. x (B,H,W,3); w (7,7,3,64) HWIO folded; b (64,)
    -> (B, H4, W4, 64) in x's dtype."""
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(dt).permute(3, 2, 0, 1),
                 stride=2, padding=3)
    y = torch.relu(y.float() + b[None, :, None, None]).to(dt)
    return F.max_pool2d(y, 3, stride=2, padding=1).permute(0, 2, 3, 1)


def pack_stem_weight(w):
    """(7,7,3,64) HWIO -> (64, STEM_KPAD) bf16, [channel][depth], the
    tensor-core body's layout: each kernel row's 21 values zero-padded to
    STEM_KROW, then the depth to STEM_KPAD."""
    w = F.pad(w.float().reshape(7, 21, STEM_CH), (0, 0, 0, STEM_KROW - 21))
    w = F.pad(w.reshape(7 * STEM_KROW, STEM_CH),
              (0, 0, 0, STEM_KPAD - 7 * STEM_KROW))
    return w.t().to(torch.bfloat16).contiguous()


def prepare_stem(w, b, dtype):
    """K4's weights for inputs of ``dtype``: (w (7,7,3,64) in dtype, b f32,
    the kernel's weight: w itself, or for bf16 ``pack_stem_weight(w)``)."""
    if tuple(w.shape) != (7, 7, 3, STEM_CH) or tuple(b.shape) != (STEM_CH,):
        raise ValueError(f'stem_pool takes a (7,7,3,64) weight and a (64,) '
                         f'bias, got {tuple(w.shape)}, {tuple(b.shape)}')
    wt = w.to(dtype).contiguous()
    kernel_w = pack_stem_weight(w) if dtype == torch.bfloat16 else wt
    return wt, b.float().contiguous(), kernel_w


def stem_pool_prepared(x, stem):
    """stem_pool on weights from ``prepare_stem(w, b, x.dtype)``: one K4
    launch."""
    w, b, kernel_w = stem
    if x.device.type == 'cpu':
        return stem_pool_ref(x, w, b)
    B, H, W, Cin = x.shape
    if Cin != 3 or w.dtype != x.dtype:
        raise ValueError(f'stem_pool takes (B,H,W,3) and weights prepared '
                         f'for its dtype, got {tuple(x.shape)} {x.dtype}, '
                         f'weights for {w.dtype}')
    x = x.contiguous()
    H4, W4 = _pool_hw(H, W)
    out = torch.empty((B, H4, W4, STEM_CH), dtype=x.dtype, device=x.device)
    _build.require_cuda(x, kernel_w, b, out)
    lib = _build.load('stem_layer1')
    rc = lib.kgdet_stem_pool(x.data_ptr(), kernel_w.data_ptr(), b.data_ptr(),
                             out.data_ptr(), B, H, W, _build.dtype_code(x),
                             _build.stream_ptr(x.device))
    _build.check(rc, 'stem_pool')
    stem_pool.launches += 1
    return out


def stem_pool(x, w, b):
    """7x7/2 conv (pad 3) with folded BN, ReLU and 3x3/2 maxpool (pad 1,
    -inf). x (B,H,W,3) f32|bf16; w (7,7,3,64); b (64,) -> (B,H4,W4,64)."""
    if x.device.type == 'cpu':
        return stem_pool_ref(x, w, b)
    return stem_pool_prepared(x, prepare_stem(w, b, x.dtype))


stem_pool.launches = 0

frozen_bottleneck_ref = bottleneck_reference


# K5 takes K8's layout (ops/resblock.py): at width 64 one prepared block
# serves both kernels
prepare_block = prepare_resblock


def frozen_bottleneck_prepared(x, blk):
    """frozen_bottleneck on weights from ``prepare_block(.., x.dtype)``: one
    K5 launch."""
    if x.device.type == 'cpu':
        return frozen_bottleneck_ref(x, *blk)
    w1, b1, w2, b2, w3, b3, wd, bd = blk
    B, H, W, Cin = x.shape
    Cout = w3.shape[1]
    has_ds = wd is not None
    if tuple(w1.shape) != (Cin, WIDTH) \
            or tuple(w2.shape) != (3, 3, WIDTH, WIDTH) \
            or tuple(w3.shape) != (WIDTH, Cout) or Cout % 64 \
            or (has_ds and tuple(wd.shape) != (Cin, Cout)) \
            or (not has_ds and Cin != Cout) \
            or any(w.dtype != x.dtype for w in (w1, w2, w3)):
        raise ValueError(
            f'frozen_bottleneck takes width {WIDTH}, Cout % 64 == 0 and '
            f'weights prepared for its dtype, got x {tuple(x.shape)} '
            f'{x.dtype}, w1 {tuple(w1.shape)} {w1.dtype}, w2 '
            f'{tuple(w2.shape)}, w3 {tuple(w3.shape)}, downsample {has_ds}')
    x = x.contiguous()
    weights = [w1, w2, w3] + ([wd] if has_ds else [])
    biases = [b1, b2, b3] + ([bd] if has_ds else [])
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    _build.require_cuda(x, *weights, *biases, out)
    lib = _build.load('stem_layer1')
    rc = lib.kgdet_frozen_bottleneck(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), w3.data_ptr(), b3.data_ptr(),
        wd.data_ptr() if has_ds else None, bd.data_ptr() if has_ds else None,
        out.data_ptr(), B, H, W, Cin, Cout, _build.vec_ok(Cin, x, *weights),
        _build.dtype_code(x), _build.stream_ptr(x.device))
    _build.check(rc, 'frozen_bottleneck')
    frozen_bottleneck.launches += 1
    return out


def frozen_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """One frozen stride-1 bottleneck, BN folded, in one launch.
    x (B,H,W,Cin); w1 (Cin,64); w2 (3,3,64,64) HWIO; w3 (64,Cout); wd
    (Cin,Cout) or None (then Cin == Cout); f32 biases -> (B,H,W,Cout)."""
    if x.device.type == 'cpu':
        return frozen_bottleneck_ref(x, w1, b1, w2, b2, w3, b3, wd, bd)
    blk = dict(zip(BLOCK_KEYS, (w1, b1, w2, b2, w3, b3, wd, bd)))
    return frozen_bottleneck_prepared(x, prepare_block(blk, x.dtype))


frozen_bottleneck.launches = 0


def stem_layer1_prepared(x, stem, blocks):
    """The frozen prefix on prepared weights (``prepare_stem``, one
    ``prepare_block`` a layer1 block): one K4 and one K5 launch a block."""
    y = stem_pool_prepared(x, stem)
    for blk in blocks:
        y = frozen_bottleneck_prepared(y, blk)
    return y


def stem_layer1(x, stem_w, stem_b, blocks):
    """Frozen prefix: image (B,H,W,3) -> layer1 output (B,H4,W4,256).
    blocks: dicts of folded weights {w1, b1, w2, b2, w3, b3, wd?, bd?} in
    the ops/resblock.py convention. One K4 and one K5 launch per block."""
    dt = x.dtype
    return stem_layer1_prepared(x, prepare_stem(stem_w, stem_b, dt),
                                [prepare_block(blk, dt) for blk in blocks])


def stem_layer1_ref(x, stem_w, stem_b, blocks):
    """Plain version of stem_layer1."""
    y = stem_pool_ref(x, stem_w, stem_b)
    for blk in blocks:
        y = frozen_bottleneck_ref(y, *[blk.get(k) for k in BLOCK_KEYS])
    return y
