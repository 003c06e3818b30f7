"""Plain versions of the port's kernels against the TPU kernels they
replace, run in Pallas interpret mode on the CPU.

K1 deform_conv_fused_ref vs pallas_deform._fused_impl; K2
deform_sample_split_ref vs deform_sample_split_pallas and _split_xla; K3
deform_sample_bwd_ref vs _deform_bwd_pallas under each of its three
generations (v1, v2, vw) and vs autograd through bilinear_gather; the
autograd Function of deform_columns_dual vs jax.grad through the JAX
package's CPU path; K4 stem_pool_ref vs pallas_stem.stem_pool_transposed;
K5 frozen_bottleneck_ref vs pallas_stem.bottleneck_transposed; K6
deform_sample_cols_ref vs deform_sample_pallas; K8 bottleneck_reference vs
pallas_resblock.fused_bottleneck; the autograd Functions over K6 and K3 vs
jax.vjp of deform_conv_fused and deform_sample_hybrid; the index math that
the deformable kernels do inside (csrc/tap_coeffs.h, compiled for the host
with g++) vs ops/deform.py::prep_indices (K1, K2, K6) and prep_indices_bwd
(K3) bit for bit; the tap-major weight layout the heads keep while they
serve; the split gather's wrapper
on strided maps and bf16 positions, and its by-value column table vs
_split_views. f32, tolerance 1e-4
(the deform kernels, the scale of tests/test_pallas_deform.py's checks; 1e-5
for K6, as its own) and 1e-5 (K4/K5/K8, as tests/test_stem_pipeline.py and
tests/test_resblock.py). The CUDA kernels themselves are held against these
plain versions on the GPU by chip_smoke.py.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import kgdet_tpu.ops.pallas_deform as pd
from kgdet_tpu.ops.pallas_stem import (
    bottleneck_transposed, from_interior, stem_pool_transposed, to_interior,
    transpose_folded)
from kgdet_tpu_torch.ops.deform import bilinear_gather
from kgdet_tpu.ops.pallas_resblock import fused_bottleneck as \
    jfused_bottleneck
from kgdet_tpu_torch.ops.deform_kernels import deform_columns_dual, \
    deform_conv_fused, deform_conv_fused_ref, deform_sample_bwd_ref, \
    deform_sample_cols, deform_sample_cols_ref, deform_sample_hybrid, \
    deform_sample_split, deform_sample_split_ref
from kgdet_tpu_torch.ops.resblock import bottleneck_reference, \
    fused_bottleneck
from tests.test_torch_ops import BOUNDARY_POS, _off_grid
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


def test_k2_plain_matches_split_pallas_and_xla(interpret_mode):
    """P = TP + 3 crosses the TPU kernel's pixel tile; positions run outside
    the map on every side. atol 1e-5, as test_split_pallas_matches_xla."""
    rng = np.random.RandomState(31)
    B, H, W, C, taps = 2, 5, 6, 128, (2, 3, 4)
    P = pd.TP + 3
    cls_f = rng.randn(B, H, W, C).astype(np.float32)
    pts_f = rng.randn(B, H, W, C).astype(np.float32)
    pos = rng.uniform(-1.5, 6.5, (B, P, sum(taps), 2)).astype(np.float32)
    args = (jnp.asarray(cls_f), jnp.asarray(pts_f), jnp.asarray(pos), taps)
    got = deform_sample_split_ref(_t(cls_f), _t(pts_f), _t(pos), taps)
    for want in (pd.deform_sample_split_pallas(*args), pd._split_xla(*args)):
        assert len(got) == len(want) == 3
        for t, pair, wpair in zip(taps, got, want):
            for g, w in zip(pair, wpair):
                assert g.shape == (B, P, t, C)
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-5)


def _bwd_case(seed, boundary):
    rng = np.random.RandomState(seed)
    B, H, W, C = 1, 5, 5, 128
    if boundary:
        pos = BOUNDARY_POS[None]
    else:
        pos = rng.uniform(-1.0, 5.5, (B, pd.TP + 2, 3, 2)).astype(np.float32)
    feat = rng.randn(B, H, W, C).astype(np.float32)
    g = rng.randn(*pos.shape[:3], C).astype(np.float32)
    return feat, pos, g


@pytest.mark.parametrize('boundary', [False, True])
@pytest.mark.parametrize('bwd', ['v1', 'v2', 'vw'])
def test_k3_plain_matches_bwd_pallas(interpret_mode, monkeypatch, bwd,
                                     boundary):
    """The sampling backward against each generation of the TPU kernel
    (which covers the two older ones, the same function), on random
    positions and on the border/integer positions; atol 1e-4 as
    tests/test_pallas_deform.py's backward checks."""
    monkeypatch.setenv('KGDET_DEFORM_BWD', bwd)
    feat, pos, g = _bwd_case(32, boundary)
    want_f, want_p = pd._deform_bwd_pallas(jnp.asarray(feat),
                                           jnp.asarray(pos), jnp.asarray(g))
    got_f, got_p = deform_sample_bwd_ref(_t(feat), _t(pos), _t(g))
    assert got_f.shape == feat.shape and got_p.shape == pos.shape
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-4)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-4)


@pytest.mark.parametrize('H,W,boundary', [(5, 5, False), (5, 5, True),
                                          (1, 4, False)])
def test_k3_plain_matches_autograd_of_gather(H, W, boundary):
    """The explicit backward equals autograd through bilinear_gather, on a
    one-row map too (the zero-padded row gets no gradient)."""
    rng = np.random.RandomState(33)
    feat = _t(rng.randn(1, H, W, 16).astype(np.float32)).requires_grad_()
    pos = _t(BOUNDARY_POS[None] if boundary else
             rng.uniform(-1, 5, (1, 7, 3, 2)).astype(np.float32)) \
        .requires_grad_()
    g = _t(rng.randn(*pos.shape[:3], 16).astype(np.float32))
    want_f, want_p = torch.autograd.grad(bilinear_gather(feat, pos),
                                         (feat, pos), g)
    got_f, got_p = deform_sample_bwd_ref(feat.detach(), pos.detach(), g)
    np.testing.assert_allclose(got_f.numpy(), want_f.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), want_p.numpy(), atol=1e-5)


def _dual_case(seed, C=16, F=8, dtype=np.float32):
    rng = np.random.RandomState(seed)
    B, H, W, taps = 2, 4, 5, (1, 4, 2)
    P = H * W
    cls_f = rng.randn(B, H, W, C).astype(dtype)
    pts_f = rng.randn(B, H, W, C).astype(dtype)
    # off the integer grid by at least 0.05, so finite differences are valid
    pos = rng.uniform(-1, 6, (B, P, sum(taps), 2))
    pos = (np.floor(pos) + 0.05 + 0.9 * (pos - np.floor(pos))).astype(dtype)
    wc = [(rng.randn(t, C, F) * .3).astype(dtype) for t in taps]
    wp = [(rng.randn(t, C, F) * .3).astype(dtype) for t in taps]
    mix = [rng.randn(B, P, len(taps) * F).astype(dtype) for _ in range(2)]
    return cls_f, pts_f, pos, wc, wp, taps, mix


def test_columns_dual_function_grads_match_jax():
    """Values and the gradients of all five inputs (two maps, positions,
    two weight tuples) against jax.grad through the JAX package's
    deform_columns_dual, whose custom_vjp runs its CPU path here. f32, 1e-4
    of each gradient's scale."""
    cls_f, pts_f, pos, wc, wp, taps, mix = _dual_case(34)

    def jloss(c, p, q, a, b):
        oc, ok = pd.deform_columns_dual(c, p, q, a, b, taps)
        return jnp.sum(oc * mix[0]) + jnp.sum(ok * mix[1])

    jargs = (jnp.asarray(cls_f), jnp.asarray(pts_f), jnp.asarray(pos),
             tuple(map(jnp.asarray, wc)), tuple(map(jnp.asarray, wp)))
    # value_and_grad: the value comes from the custom_vjp's forward rule
    # (the split path), not from the fused inference kernel
    want_val, want = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *jargs)
    targs = [_t(cls_f).requires_grad_(), _t(pts_f).requires_grad_(),
             _t(pos).requires_grad_(),
             [_t(w).requires_grad_() for w in wc],
             [_t(w).requires_grad_() for w in wp]]
    oc, ok = deform_columns_dual(*targs, taps)
    assert oc.grad_fn is not None and 'ColumnsDualGrad' in type(
        oc.grad_fn).__name__
    np.testing.assert_allclose(
        (oc * _t(mix[0])).sum().item() + (ok * _t(mix[1])).sum().item(),
        float(want_val), rtol=1e-5)
    ((oc * _t(mix[0])).sum() + (ok * _t(mix[1])).sum()).backward()
    flat_got = targs[:3] + targs[3] + targs[4]
    flat_want = list(want[:3]) + list(want[3]) + list(want[4])
    assert len(flat_got) == len(flat_want) == 9
    for g, w in zip(flat_got, flat_want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w,
                                   atol=1e-4 * np.abs(w).max())


def test_columns_dual_function_gradcheck():
    """torch.autograd.gradcheck of the Function in f64, positions away from
    integer coordinates (bilinear sampling is not differentiable there)."""
    cls_f, pts_f, pos, wc, wp, taps, _ = _dual_case(35, C=4, F=3,
                                                    dtype=np.float64)
    cls_f, pts_f, pos = cls_f[:1, :3, :3], pts_f[:1, :3, :3], pos[:1, :9]
    pos = np.clip(pos, -0.9, 2.9)
    inputs = [_t(a).requires_grad_() for a in (cls_f, pts_f, pos, *wc, *wp)]

    def fn(c, p, q, *ws):
        return deform_columns_dual(c, p, q, ws[:3], ws[3:], taps)

    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-6)


def test_columns_dual_without_grad_takes_the_fused_path():
    """No gradient wanted: the per-column fused path, same values as the
    differentiated path's forward."""
    cls_f, pts_f, pos, wc, wp, taps, _ = _dual_case(36)
    args = [_t(cls_f), _t(pts_f), _t(pos), list(map(_t, wc)),
            list(map(_t, wp))]
    plain = deform_columns_dual(*args, taps)
    assert plain[0].grad_fn is None
    args[2] = args[2].clone().requires_grad_()
    with torch.no_grad():
        assert deform_columns_dual(*args, taps)[0].grad_fn is None
    diff = deform_columns_dual(*args, taps)
    for a, b in zip(plain, diff):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=1e-5)


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


K6_CASES = {
    # the three shapes of tests/test_pallas_deform.py
    'reference': (2, 6, 7, 5, 11, (-2, 9)),
    'all_outside': (1, 5, 5, 2, 3, None),
    'pixel_tile_edge': (1, 4, 4, 3, pd.TP + 3, (0, 3)),
    # a one-row map: the port pads it to two rows inside, the TPU kernel is
    # given the padded map, as kgdet_tpu's deform_sample does
    'one_row': (1, 1, 6, 3, 7, (-1.5, 6.5)),
}


@pytest.mark.parametrize('case', sorted(K6_CASES))
def test_k6_plain_matches_sample_pallas(interpret_mode, case):
    """The one-map column gather against the TPU kernel; atol 1e-5 as
    tests/test_pallas_deform.py (both sum four f32 products)."""
    B, H, W, K, P, span = K6_CASES[case]
    C = 128
    rng = np.random.RandomState(40 + len(case))
    feat = rng.randn(B, H, W, C).astype(np.float32)
    if span is None:
        pos = np.full((B, P, K, 2), -10.0, np.float32)
    else:
        pos = rng.uniform(*span, (B, P, K, 2)).astype(np.float32)
    padded = np.pad(feat, ((0, 0), (0, max(2 - H, 0)), (0, max(2 - W, 0)),
                           (0, 0)))
    want = pd.deform_sample_pallas(jnp.asarray(padded), jnp.asarray(pos))
    before = deform_sample_cols.launches
    got = deform_sample_cols(_t(feat), _t(pos))      # CPU: the plain version
    assert deform_sample_cols.launches == before
    np.testing.assert_array_equal(
        got.numpy(), deform_sample_cols_ref(_t(feat), _t(pos)).numpy())
    assert got.shape == (B, P, K, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if span is None:
        assert not got.any()


@pytest.mark.parametrize('case', ['downsample', 'identity', 'border'])
def test_k8_plain_matches_fused_bottleneck_pallas(case):
    """The three cases of tests/test_resblock.py: with a downsample, with
    the identity, and a single row step whose halo rows are both outside
    the image under a distinctive border (conv2 must see zeros there, not
    relu(b1)). f32, rtol 1e-5 / atol 1e-5 as there."""
    cin, width, cout = (16, 8, 16) if case == 'identity' else (8, 8, 16)
    H = W = 8 if case == 'border' else 16
    rng = np.random.RandomState(50)
    x = rng.randn(1 if case == 'border' else 2, H, W, cin).astype(np.float32)
    if case == 'border':
        x[:, 0], x[:, -1] = 5.0, -5.0
    ws = _block_weights(cin, width, cout, case != 'identity', seed=51)
    want = jfused_bottleneck(jnp.asarray(x), *[
        None if a is None else jnp.asarray(a) for a in ws], interpret=True)
    tws = [None if a is None else _t(a) for a in ws]
    before = fused_bottleneck.launches
    got = fused_bottleneck(_t(x), *tws)              # CPU: the plain version
    assert fused_bottleneck.launches == before
    np.testing.assert_array_equal(
        got.numpy(), bottleneck_reference(_t(x), *tws).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fused_conv_function_matches_pallas_custom_vjp(interpret_mode):
    """The same Function against jax.vjp of pallas_deform.deform_conv_fused
    itself (K6's and K3's TPU kernels in interpret mode, C = 128): output
    and the three gradients, 1e-4 of each gradient's scale."""
    rng = np.random.RandomState(25)
    B, H, W, C, K, F = 1, 4, 5, 128, 4, 128
    P = H * W
    feat = rng.randn(B, H, W, C).astype(np.float32)
    pos = _off_grid(rng, -1, 5.5, (B, P, K, 2))
    w = (rng.randn(K, C, F) * .1).astype(np.float32)
    ct = rng.randn(B, P, F).astype(np.float32)
    want, vjp = jax.vjp(pd.deform_conv_fused, jnp.asarray(feat),
                        jnp.asarray(pos), jnp.asarray(w))
    want_g = vjp(jnp.asarray(ct))
    leaves = [_t(a).requires_grad_() for a in (feat, pos, w)]
    got = deform_conv_fused(*leaves)
    got_g = torch.autograd.grad(got, leaves, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    for g, wg in zip(got_g, want_g):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg,
                                   atol=1e-4 * np.abs(wg).max())


def test_sample_function_matches_jax_vjp(interpret_mode):
    """deform_sample_hybrid (K6 forward, K3 backward; plain versions on the
    CPU) against jax.vjp of pallas_deform.deform_sample_hybrid in interpret
    mode: columns and both gradients, 1e-4 of each gradient's scale."""
    rng = np.random.RandomState(26)
    B, H, W, C, K, P = 1, 5, 6, 128, 2, 7
    feat = rng.randn(B, H, W, C).astype(np.float32)
    pos = _off_grid(rng, -1, 6.5, (B, P, K, 2))
    ct = rng.randn(B, P, K, C).astype(np.float32)
    want, vjp = jax.vjp(pd.deform_sample_hybrid, jnp.asarray(feat),
                        jnp.asarray(pos))
    want_g = vjp(jnp.asarray(ct))
    leaves = [_t(a).requires_grad_() for a in (feat, pos)]
    got = deform_sample_hybrid(*leaves)
    assert 'SampleGrad' in type(got.grad_fn).__name__
    got_g = torch.autograd.grad(got, leaves, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    for g, wg in zip(got_g, want_g):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg,
                                   atol=1e-4 * np.abs(wg).max())


# ------------------------------------ the in-kernel index math, through g++
_COEFFS_SHIM = r'''
#include "tap_coeffs.h"
extern "C" void coeffs(const float* yx, int n, int H, int W, int* starts,
                       float* w4) {
  for (int i = 0; i < n; ++i) {
    float w[4];
    kgdet::tap_coeffs(yx[2 * i], yx[2 * i + 1], H, W, starts[2 * i],
                      starts[2 * i + 1], w);
    for (int j = 0; j < 4; ++j) w4[4 * i + j] = w[j];
  }
}
extern "C" void coeffs_bwd(const float* yx, int n, int H, int W, int* starts,
                           float* wd12) {
  for (int i = 0; i < n; ++i) {
    float w[12];
    kgdet::tap_coeffs_bwd(yx[2 * i], yx[2 * i + 1], H, W, starts[2 * i],
                          starts[2 * i + 1], w);
    for (int j = 0; j < 12; ++j) wd12[12 * i + j] = w[j];
  }
}
'''


@pytest.fixture(scope='module')
def host_coeffs(tmp_path_factory):
    """csrc/tap_coeffs.h, the header the CUDA kernels take their
    coefficients from, compiled for the host with g++ (no contraction of
    a * b + c, so no bit can differ for that reason) and loaded with
    ctypes. run(pos, H, W) gives the forward's starts and four weights,
    run(pos, H, W, bwd=True) the backward's starts and twelve
    coefficients."""
    import ctypes
    import shutil
    import subprocess

    from kgdet_tpu_torch.ops._build import CSRC
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    tmp = tmp_path_factory.mktemp('tap_coeffs')
    (tmp / 'shim.cpp').write_text(_COEFFS_SHIM)
    lib = tmp / 'libcoeffs.so'
    subprocess.run([gxx, '-O2', '-ffp-contract=off', '-std=c++17', '-shared',
                    '-fPIC', f'-I{CSRC}', str(tmp / 'shim.cpp'), '-o',
                    str(lib)], check=True)
    cdll = ctypes.CDLL(str(lib))
    for fn in (cdll.coeffs, cdll.coeffs_bwd):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = None

    def run(pos, H, W, bwd=False):
        """pos (n, 2) f32 -> starts (n, 2), w4 (n, 4) or wd12 (n, 12)."""
        pos = np.ascontiguousarray(pos, np.float32)
        n = len(pos)
        outs = (np.zeros((n, 2), np.int32),
                np.zeros((n, 12 if bwd else 4), np.float32))
        (cdll.coeffs_bwd if bwd else cdll.coeffs)(
            pos.ctypes.data, n, H, W, *[o.ctypes.data for o in outs])
        return outs
    return run


def _boundary_grid(size):
    """Every quarter step from -2.5 to size + 1.5 (the exact integers among
    them), -0.0, -1, size - 1, size and +-1e9."""
    steps = np.arange(-2.5, size + 1.5 + 1e-6, 0.25)
    return np.concatenate([steps, [-0.0, -1.0, size - 1.0, size, 1e9, -1e9]]) \
        .astype(np.float32)


@pytest.mark.parametrize('H,W', [(6, 7), (2, 2)])
def test_kernel_index_math_equals_prep_indices_bit_for_bit(host_coeffs, H, W):
    """K6's and K2's in-kernel coefficients (csrc/tap_coeffs.h) against
    ops/deform.py::prep_indices on the full boundary grid of both axes:
    starts equal, every weight equal in every bit."""
    from kgdet_tpu_torch.ops.deform import prep_indices
    ys, xs = _boundary_grid(H), _boundary_grid(W)
    pos = np.stack(np.meshgrid(ys, xs, indexing='ij'), -1).reshape(-1, 2)
    assert np.signbit(pos[:, 0]).any() and (pos == 0).any()
    starts, w4 = host_coeffs(pos, H, W)
    tpos = _t(pos).reshape(1, -1, 1, 2)
    want_s, want_w = prep_indices(tpos, H, W)
    np.testing.assert_array_equal(starts, want_s.reshape(-1, 2).numpy())
    np.testing.assert_array_equal(
        w4.view(np.int32), want_w.reshape(-1, 4).numpy().view(np.int32))
    # the far positions match no corner; the rest of the grid has live taps
    far = np.abs(pos).max(-1) >= 1e9
    assert far.any() and not w4[far].any() and w4[~far].any()
    assert starts.min() >= 0 and starts[:, 1].max() + 1 < H * W


@pytest.mark.parametrize('H,W', [(6, 7), (2, 2)])
def test_kernel_index_math_equals_prep_indices_bwd_bit_for_bit(host_coeffs,
                                                               H, W):
    """K3's in-kernel coefficients (csrc/tap_coeffs.h::tap_coeffs_bwd)
    against ops/deform.py::prep_indices_bwd on the forward test's grid of
    both axes plus NaN: starts equal, all twelve coefficients [w4 | u4 | v4]
    equal in every bit (the sign of a zero too), and its first four equal to
    the forward's."""
    from kgdet_tpu_torch.ops.deform import prep_indices_bwd
    ys = np.append(_boundary_grid(H), np.float32('nan'))
    xs = np.append(_boundary_grid(W), np.float32('nan'))
    pos = np.stack(np.meshgrid(ys, xs, indexing='ij'), -1).reshape(-1, 2)
    starts, wd12 = host_coeffs(pos, H, W, bwd=True)
    want_s, want_w = prep_indices_bwd(_t(pos).reshape(1, -1, 1, 2), H, W)
    np.testing.assert_array_equal(starts, want_s.reshape(-1, 2).numpy())
    np.testing.assert_array_equal(
        wd12.view(np.int32), want_w.reshape(-1, 12).numpy().view(np.int32))
    fwd_s, w4 = host_coeffs(pos, H, W)
    np.testing.assert_array_equal(fwd_s, starts)
    np.testing.assert_array_equal(w4.view(np.int32),
                                  wd12[:, :4].view(np.int32))
    # derivatives are -1, 0 or +1 times the other axis' weight; far and NaN
    # positions match no corner; an integer coordinate has a zero weight and
    # a live derivative (the one-sided one of floor()'s cell)
    dead = (np.abs(pos).max(-1) >= 1e9) | np.isnan(pos).any(-1)
    assert dead.any() and not wd12[dead].any() and wd12[~dead].any()
    assert np.isfinite(wd12).all() and np.abs(wd12).max() <= 1.0
    assert ((wd12[:, :4] == 0) & (wd12[:, 4:8] != 0)).any()
    assert starts.min() >= 0 and starts[:, 1].max() + 1 < H * W


def test_served_weight_layout_is_made_once():
    """DeformConvWeight.tap_major while the module serves (eval(), no
    gradient wanted): the same tensor twice, equal to the layout made anew,
    per dtype; dropped by train(), load_state_dict, a move of the module and
    an in-place change of the weight; never kept where a gradient could be
    wanted. The serial head's side-by-side pts weight follows its parts."""
    from kgdet_tpu_torch.models.kgdet_head import DeformConvWeight
    from kgdet_tpu_torch.models.serial_head import SerialKpHead
    m = DeformConvWeight(6, 4, 3)
    torch.nn.init.normal_(m.weight)

    def fresh(dtype):
        w = m.weight.detach()
        return w.reshape(4, 6, 9).permute(2, 1, 0).to(dtype).contiguous()

    assert m.tap_major(torch.float32) is not m.tap_major(torch.float32)
    m.eval()
    kept = m.tap_major(torch.float32)       # grad enabled: nothing is kept
    assert kept.requires_grad and m.tap_major(torch.float32) is not kept
    with torch.no_grad():
        kept = m.tap_major(torch.float32)
        assert m.tap_major(torch.float32) is kept
        assert kept.shape == (9, 6, 4) and kept.is_contiguous()
        assert torch.equal(kept, fresh(torch.float32))
        half = m.tap_major(torch.bfloat16)
        assert half.dtype == torch.bfloat16 and half is not kept
        assert torch.equal(half, fresh(torch.bfloat16))
        kept = m.tap_major(torch.float32)
        assert m.tap_major(torch.float32) is kept
        m.train()
        assert m.tap_major(torch.float32) is not kept
        m.eval()
        kept = m.tap_major(torch.float32)
        m.load_state_dict({'weight': torch.ones_like(m.weight)})
        again = m.tap_major(torch.float32)
        assert again is not kept and bool((again == 1).all())
        m.weight.mul_(2.0)                  # in place, as an optimizer does
        assert bool((m.tap_major(torch.float32) == 2).all())
        kept = m.tap_major(torch.float32)
        m.to(torch.float64)
        assert m.tap_major(torch.float32) is not kept
    assert sorted(m.state_dict()) == ['weight']

    head = SerialKpHead(num_classes=3, in_channels=8, feat_channels=8,
                        point_feat_channels=8, stacked_convs=1, num_keypts=4,
                        parallel=True, gn_groups=4).eval()
    parts = [head.keypts_refine_dfmconv, head.reppts_refine_dfmconv]
    for mod in parts:
        torch.nn.init.normal_(mod.weight)
    with torch.no_grad():
        cat = head.pts_weight(parts, torch.float32)
        assert head.pts_weight(parts, torch.float32) is cat
        assert torch.equal(cat, torch.cat(
            [mod.tap_major(torch.float32) for mod in parts], dim=-1))
        head.train()
        assert head.pts_weight(parts, torch.float32) is not cat
        head.eval()
        cat = head.pts_weight(parts, torch.float32)
        parts[0].weight.zero_()
        assert not head.pts_weight(parts, torch.float32)[..., :8].any()
    assert head.pts_weight(parts, torch.float32).requires_grad


# ------------------------------------------- the split gather's wrapper edges
@pytest.mark.parametrize('case', ['strided_maps', 'bf16_positions'])
def test_k2_wrapper_edges_match_plain_and_split_pallas(interpret_mode, case):
    """deform_sample_split with branch maps that are views of two storages
    with different strides, and with positions in bf16 (the position math
    runs in f32 on the widened values), against its plain version (equal)
    and the TPU kernel in interpret mode; atol 1e-5 as the case above."""
    rng = np.random.RandomState(41)
    B, H, W, C, taps = 2, 5, 6, 128, (2, 3, 4)
    P = pd.TP + 3
    wide = _t(rng.randn(B, H, W, 2 * C + 3).astype(np.float32))
    cls_f = wide[..., 3:3 + C]
    pts_f = _t(rng.randn(B, W, H, C).astype(np.float32)).transpose(1, 2)
    assert not cls_f.is_contiguous() and not pts_f.is_contiguous()
    pos = _t(rng.uniform(-1.5, 6.5, (B, P, sum(taps), 2)).astype(np.float32))
    if case == 'bf16_positions':
        pos = pos.bfloat16()
    got = deform_sample_split(cls_f, pts_f, pos, taps)
    plain = deform_sample_split_ref(cls_f, pts_f, pos, taps)
    want = pd.deform_sample_split_pallas(
        jnp.asarray(cls_f.contiguous().numpy()),
        jnp.asarray(pts_f.contiguous().numpy()),
        jnp.asarray(pos.float().numpy()), taps)
    for t, pair, ppair, wpair in zip(taps, got, plain, want):
        for g, p_, w in zip(pair, ppair, wpair):
            assert g.shape == (B, P, t, C) and g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), p_.numpy())
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize('taps', [(9, 25, 49), (83,), (1, 2)])
def test_k2_column_table_agrees_with_split_views(taps):
    """The layout the kernel is given by value against the views the wrapper
    returns: per column its first tap, its tap count and the offsets of its
    cls and pts tensors; every tap falls in exactly one column."""
    from kgdet_tpu_torch.ops.deform_kernels import _split_table, _split_views
    B, P, C = 2, 7, 8
    K = sum(taps)
    buf = torch.zeros(B * P * K * 2 * C)
    views = _split_views(buf, B, P, C, taps)
    table = _split_table(taps, B, P, C)
    assert table.n == len(taps) == len(views)
    first = 0
    for i, (t, pair) in enumerate(zip(taps, views)):
        assert (table.first[i], table.taps[i]) == (first, t)
        for m in range(2):
            assert pair[m].shape == (B, P, t, C) and pair[m].is_contiguous()
            assert table.off[m][i] == pair[m].storage_offset()
        first += t
    assert first == K
    # the kernel's own walk: tap k of pixel bp goes to column i, row
    # (bp * taps[i] + k - first[i]) of both tensors; mark and count
    for bp in range(B * P):
        for k in range(K):
            i = max(j for j in range(table.n) if k >= table.first[j])
            row = (bp * table.taps[i] + k - table.first[i]) * C
            for m in range(2):
                buf[table.off[m][i] + row:table.off[m][i] + row + C] += 1
    assert bool((buf == 1).all())
    # more columns than the table holds: refused on the CPU as on the card
    feat = torch.zeros(1, 3, 3, C)
    with pytest.raises(ValueError, match='columns'):
        deform_sample_split(feat, feat, torch.zeros(1, 4, 9, 2), (1,) * 9)
