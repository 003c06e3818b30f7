"""The port's CUDA kernels against their plain versions at edge shapes.

Needs a CUDA card and nvcc; every test skips, in its fixture, without one.
The main-path shapes are checked by chip_smoke.py; these cases cover ragged
tiles: pixel counts, channel counts and image sizes that are not multiples
of the kernels' tile sizes, maps under 2x2, and the wrappers' shape checks.
f32 tolerance rtol 1e-5, atol 1e-4 (chip_smoke.py's). Imports no JAX, so
it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import pytest
import torch

from kgdet_tpu_torch.ops import deform_kernels as dk
from kgdet_tpu_torch.ops import stem_kernels as sk

TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _randn(gen, *shape, std=1.0):
    return (torch.randn(shape, generator=gen) * std).cuda()


@pytest.mark.parametrize('H,W,C,F,P,K', [
    (5, 7, 96, 80, 35, 4),      # C, F off the 32/64 tiles; one pixel tile
    (9, 6, 256, 256, 130, 9),   # P crosses two pixel-tile edges
    (1, 5, 64, 64, 20, 3),      # one-row map: zero-padded to 2 rows
])
def test_k1_edge_shapes(gen, H, W, C, F, P, K):
    feat = _randn(gen, 2, H, W, C)
    pos = torch.rand((2, P, K, 2), generator=gen).cuda() \
        * torch.tensor([H + 4.0, W + 4.0], device='cuda') - 2.0
    w = _randn(gen, K, C, F, std=(K * C) ** -0.5)
    before = dk.deform_conv_fused.launches
    got = dk.deform_conv_fused(feat, pos, w)
    assert dk.deform_conv_fused.launches == before + 1
    want = dk.deform_conv_fused_ref(feat, pos, w)
    torch.testing.assert_close(got, want, **TOL)
    got16 = dk.deform_conv_fused(feat.bfloat16(), pos, w.bfloat16())
    ref = dk.deform_conv_fused_ref(feat.bfloat16().float(), pos,
                                   w.bfloat16().float())
    plain16 = dk.deform_conv_fused_ref(feat.bfloat16(), pos, w.bfloat16())
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - ref).abs().max() <= \
        2 * (plain16.float() - ref).abs().max()


@pytest.mark.parametrize('H,W', [(37, 50), (64, 96), (8, 8)])
def test_k4_edge_shapes(gen, H, W):
    x = _randn(gen, 2, H, W, 3)
    w = _randn(gen, 7, 7, 3, 64, std=(2.0 / 147) ** 0.5)
    b = _randn(gen, 64, std=0.1)
    got = sk.stem_pool(x, w, b)
    want = sk.stem_pool_ref(x, w, b)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want.contiguous(), **TOL)


@pytest.mark.parametrize('H,W,cin,cout,ds', [
    (13, 21, 64, 256, True),    # partial 8x8 tiles on both edges
    (8, 16, 128, 128, False),   # identity path, Cout = 2 x 64
    (3, 5, 96, 192, True),      # Cin off the 32-channel chunk
])
def test_k5_edge_shapes(gen, H, W, cin, cout, ds):
    x = torch.relu(_randn(gen, 2, H, W, cin))
    ws = [_randn(gen, cin, 64, std=cin ** -0.5), _randn(gen, 64, std=.1),
          _randn(gen, 3, 3, 64, 64, std=(9 * 64) ** -0.5),
          _randn(gen, 64, std=.1), _randn(gen, 64, cout, std=64 ** -0.5),
          _randn(gen, cout, std=.1)]
    ws += ([_randn(gen, cin, cout, std=cin ** -0.5),
            _randn(gen, cout, std=.1)] if ds else [None, None])
    got = sk.frozen_bottleneck(x, *ws)
    want = sk.frozen_bottleneck_ref(x, *ws)
    torch.testing.assert_close(got, want.contiguous(), **TOL)


def test_wrappers_raise_on_shapes_the_kernels_do_not_take(gen):
    x = _randn(gen, 1, 16, 16, 4)
    with pytest.raises(ValueError):
        sk.stem_pool(x, _randn(gen, 7, 7, 4, 64), _randn(gen, 64))
    y = _randn(gen, 1, 8, 8, 64)
    with pytest.raises(ValueError):           # width 32, not 64
        sk.frozen_bottleneck(y, _randn(gen, 64, 32), _randn(gen, 32),
                             _randn(gen, 3, 3, 32, 32), _randn(gen, 32),
                             _randn(gen, 32, 64), _randn(gen, 64))
    with pytest.raises(TypeError):            # f16 is not a kernel dtype
        dk.deform_conv_fused(_randn(gen, 1, 4, 4, 32).half(),
                             _randn(gen, 1, 5, 2, 2),
                             _randn(gen, 2, 32, 16).half())
