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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from kgdet_tpu_torch.ops import _build
from kgdet_tpu_torch.ops.resblock import bottleneck_reference

STEM_CH = 64
WIDTH = 64


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


def stem_pool(x, w, b):
    """7x7/2 conv (pad 3) with folded BN, ReLU and 3x3/2 maxpool (pad 1,
    -inf). x (B,H,W,3) f32|bf16; w (7,7,3,64); b (64,) -> (B,H4,W4,64)."""
    if x.device.type == 'cpu':
        return stem_pool_ref(x, w, b)
    B, H, W, Cin = x.shape
    if Cin != 3 or tuple(w.shape) != (7, 7, 3, STEM_CH) \
            or tuple(b.shape) != (STEM_CH,):
        raise ValueError(f'stem_pool takes (B,H,W,3) with a (7,7,3,64) '
                         f'weight, got {tuple(x.shape)}, {tuple(w.shape)}')
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    b = b.float().contiguous()
    H4, W4 = _pool_hw(H, W)
    out = torch.empty((B, H4, W4, STEM_CH), dtype=x.dtype, device=x.device)
    _build.require_cuda(x, w, b, out)
    lib = _build.load('stem_layer1')
    rc = lib.kgdet_stem_pool(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                             out.data_ptr(), B, H, W, _build.dtype_code(x),
                             _build.stream_ptr(x.device))
    _build.check(rc, 'stem_pool')
    stem_pool.launches += 1
    return out


stem_pool.launches = 0

frozen_bottleneck_ref = bottleneck_reference


def frozen_bottleneck(x, w1, b1, w2, b2, w3, b3, wd=None, bd=None):
    """One frozen stride-1 bottleneck, BN folded, in one launch.
    x (B,H,W,Cin); w1 (Cin,64); w2 (3,3,64,64) HWIO; w3 (64,Cout); wd
    (Cin,Cout) or None (then Cin == Cout); f32 biases -> (B,H,W,Cout)."""
    if x.device.type == 'cpu':
        return frozen_bottleneck_ref(x, w1, b1, w2, b2, w3, b3, wd, bd)
    B, H, W, Cin = x.shape
    Cout = w3.shape[1]
    has_ds = wd is not None
    if tuple(w1.shape) != (Cin, WIDTH) \
            or tuple(w2.shape) != (3, 3, WIDTH, WIDTH) \
            or tuple(w3.shape) != (WIDTH, Cout) or Cout % 64 \
            or (has_ds and tuple(wd.shape) != (Cin, Cout)) \
            or (not has_ds and Cin != Cout):
        raise ValueError(
            f'frozen_bottleneck takes width {WIDTH} and Cout % 64 == 0, got '
            f'x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 '
            f'{tuple(w2.shape)}, w3 {tuple(w3.shape)}, downsample {has_ds}')
    dt = x.dtype
    x = x.contiguous()
    ws = [w.to(dt).contiguous() for w in (w1, w2, w3)]
    bs = [v.float().contiguous() for v in (b1, b2, b3)]
    ds = ([wd.to(dt).contiguous(), bd.float().contiguous()] if has_ds
          else [])
    out = torch.empty((B, H, W, Cout), dtype=dt, device=x.device)
    _build.require_cuda(x, *ws, *bs, *ds, out)
    lib = _build.load('stem_layer1')
    rc = lib.kgdet_frozen_bottleneck(
        x.data_ptr(), ws[0].data_ptr(), bs[0].data_ptr(), ws[1].data_ptr(),
        bs[1].data_ptr(), ws[2].data_ptr(), bs[2].data_ptr(),
        ds[0].data_ptr() if has_ds else None,
        ds[1].data_ptr() if has_ds else None, out.data_ptr(),
        B, H, W, Cin, Cout, _build.dtype_code(x),
        _build.stream_ptr(x.device))
    _build.check(rc, 'frozen_bottleneck')
    frozen_bottleneck.launches += 1
    return out


frozen_bottleneck.launches = 0


def _chain(stem_fn, block_fn, x, stem_w, stem_b, blocks):
    y = stem_fn(x, stem_w, stem_b)
    for blk in blocks:
        y = block_fn(y, blk['w1'], blk['b1'], blk['w2'], blk['b2'],
                     blk['w3'], blk['b3'], blk.get('wd'), blk.get('bd'))
    return y


def stem_layer1(x, stem_w, stem_b, blocks):
    """Frozen prefix: image (B,H,W,3) -> layer1 output (B,H4,W4,256).
    blocks: dicts of folded weights {w1, b1, w2, b2, w3, b3, wd?, bd?} in
    the ops/resblock.py convention. One K4 and one K5 launch per block."""
    return _chain(stem_pool, frozen_bottleneck, x, stem_w, stem_b, blocks)


def stem_layer1_ref(x, stem_w, stem_b, blocks):
    """Plain version of stem_layer1."""
    return _chain(stem_pool_ref, frozen_bottleneck_ref, x, stem_w, stem_b,
                  blocks)
