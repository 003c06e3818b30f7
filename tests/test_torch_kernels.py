"""Plain versions of the port's kernels against the TPU kernels they
replace, run in Pallas interpret mode on the CPU.

K1 deform_conv_fused_ref vs pallas_deform._fused_impl; K4 stem_pool_ref vs
pallas_stem.stem_pool_transposed; K5 frozen_bottleneck_ref vs
pallas_stem.bottleneck_transposed. f32, tolerance 1e-4 (K1, the scale of
tests/test_pallas_deform.py's fused checks) and 1e-5 (K4/K5, as
tests/test_stem_pipeline.py). The CUDA kernels themselves are held
against these plain versions on the GPU by chip_smoke.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import kgdet_tpu.ops.pallas_deform as pd
from kgdet_tpu.ops.pallas_stem import (
    bottleneck_transposed, from_interior, stem_pool_transposed, to_interior,
    transpose_folded)
from kgdet_tpu_torch.ops.deform_kernels import deform_columns_dual, \
    deform_conv_fused_ref
from kgdet_tpu_torch.ops.stem_kernels import frozen_bottleneck_ref, \
    stem_layer1_ref, stem_pool_ref

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run pallas_call in interpreter mode (as tests/test_pallas_deform.py
    does)."""
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw['interpret'] = True
        return orig(*args, **kw)

    monkeypatch.setattr(pl, 'pallas_call', patched)
    yield


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize('K', [4, 9])
def test_k1_plain_matches_fused_pallas(interpret_mode, K):
    """P = 2*TPF+5 crosses the kernel's pixel-tile edge; positions run
    outside the map on every side."""
    rng = np.random.RandomState(20 + K)
    B, H, W, C, F, P = 1, 5, 6, 128, 128, 2 * pd.TPF + 5
    feat = rng.randn(B, H, W, C).astype(np.float32)
    pos = rng.uniform(-2, 8, (B, P, K, 2)).astype(np.float32)
    w = (rng.randn(K, C, F) * 0.1).astype(np.float32)
    want = pd._fused_impl(jnp.asarray(feat), jnp.asarray(pos),
                          jnp.asarray(w))
    got = deform_conv_fused_ref(_t(feat), _t(pos), _t(w))
    assert got.shape == (B, P, F)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_k1_columns_dual_matches_pallas(interpret_mode):
    """The per-column, per-branch split of deform_columns_dual."""
    rng = np.random.RandomState(30)
    B, H, W, C, F, taps = 1, 4, 5, 128, 128, (1, 4)
    P = H * W
    cls_f = rng.randn(B, H, W, C).astype(np.float32)
    pts_f = rng.randn(B, H, W, C).astype(np.float32)
    pos = rng.uniform(-1, 6, (B, P, sum(taps), 2)).astype(np.float32)
    wc = [(rng.randn(t, C, F) * .1).astype(np.float32) for t in taps]
    wp = [(rng.randn(t, C, F) * .1).astype(np.float32) for t in taps]
    want = pd.deform_columns_dual(
        jnp.asarray(cls_f), jnp.asarray(pts_f), jnp.asarray(pos),
        tuple(map(jnp.asarray, wc)), tuple(map(jnp.asarray, wp)), taps)
    got = deform_columns_dual(_t(cls_f), _t(pts_f), _t(pos),
                              list(map(_t, wc)), list(map(_t, wp)), taps)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)


def _stem_weights(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(7, 7, 3, 64).astype(np.float32) * .2,
            rng.randn(64).astype(np.float32) * .1)


@pytest.mark.parametrize('H,W', [(32, 8), (64, 16)])
def test_k4_plain_matches_stem_pallas(H, W):
    rng = np.random.RandomState(1)
    x = rng.randn(2, H, W, 3).astype(np.float32)
    w, b = _stem_weights()
    want = from_interior(stem_pool_transposed(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True))
    got = stem_pool_ref(_t(x), _t(w), _t(b))
    assert got.shape == (2, H // 4, W // 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _block_weights(cin, width, cout, ds, seed):
    """Folded weights in the bottleneck_reference convention, as
    tests/test_stem_pipeline.py makes them."""
    rng = np.random.RandomState(seed)
    ws = [rng.randn(cin, width) * .2, rng.randn(width) * .1,
          rng.randn(3, 3, width, width) * .1, rng.randn(width) * .1,
          rng.randn(width, cout) * .2, rng.randn(cout) * .1]
    ws += [rng.randn(cin, cout) * .2, rng.randn(cout) * .1] if ds \
        else [None, None]
    return [None if a is None else a.astype(np.float32) for a in ws]


@pytest.mark.parametrize('ds', [True, False])
def test_k5_plain_matches_block_pallas(ds):
    cin, width, cout = (8, 8, 16) if ds else (16, 8, 16)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 16, 4, cin).astype(np.float32)
    ws = _block_weights(cin, width, cout, ds, seed=6)
    blk = transpose_folded(*[None if a is None else jnp.asarray(a)
                             for a in ws])
    want = from_interior(bottleneck_transposed(
        to_interior(jnp.asarray(x)), **blk, interpret=True))
    got = frozen_bottleneck_ref(_t(x), *[None if a is None else _t(a)
                                         for a in ws])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_stem_layer1_plain_matches_pipeline():
    """The chained prefix (K4 then three K5) against the Pallas chain."""
    from kgdet_tpu.ops.pallas_stem import stem_layer1_pipeline
    rng = np.random.RandomState(7)
    x = rng.randn(1, 32, 16, 3).astype(np.float32)
    sw, sb = _stem_weights(seed=8)
    specs = [(64, 8, 32, True), (32, 8, 32, False), (32, 8, 32, False)]
    ref_ws = [_block_weights(*s, seed=10 + i) for i, s in enumerate(specs)]
    blocks_j = [transpose_folded(*[None if a is None else jnp.asarray(a)
                                   for a in ws]) for ws in ref_ws]
    want = stem_layer1_pipeline(jnp.asarray(x), jnp.asarray(sw),
                                jnp.asarray(sb), blocks_j, interpret=True)
    keys = ('w1', 'b1', 'w2', 'b2', 'w3', 'b3', 'wd', 'bd')
    blocks_t = [{k: _t(a) for k, a in zip(keys, ws) if a is not None}
                for ws in ref_ws]
    got = stem_layer1_ref(_t(x), _t(sw), _t(sb), blocks_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
