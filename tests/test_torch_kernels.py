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
pallas_resblock.fused_bottleneck, through both its entries, and the
layout prepare_resblock keeps; the autograd Functions over K6 and K3 vs
jax.vjp of deform_conv_fused and deform_sample_hybrid; the index math that
the deformable kernels do inside (csrc/tap_coeffs.h, compiled for the host
with g++) vs ops/deform.py::prep_indices (K1, K2, K6) and prep_indices_bwd
(K3) bit for bit; the tensor-core bodies' tile geometry and the
bottleneck's schedule (csrc/prefix_index.h through g++) vs F.conv2d and an
enumeration of the steps; the tap-major weight layout the heads keep while they
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
from kgdet_tpu_torch.ops.resblock import BLOCK_KEYS, bottleneck_reference, \
    fused_bottleneck, fused_bottleneck_prepared, prepare_resblock
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


@pytest.mark.parametrize('case', ['downsample', 'identity', 'border'])
def test_k8_prepared_plain_matches_fused_bottleneck_pallas(case):
    """The same three cases through fused_bottleneck_prepared on the weights
    prepare_resblock keeps: on the CPU the plain version, equal to the
    unprepared entry bit for bit and to the TPU kernel within 1e-5."""
    cin, width, cout = (16, 8, 16) if case == 'identity' else (8, 8, 16)
    H = W = 8 if case == 'border' else 16
    rng = np.random.RandomState(52)
    x = rng.randn(1 if case == 'border' else 2, H, W, cin).astype(np.float32)
    if case == 'border':
        x[:, 0], x[:, -1] = 5.0, -5.0
    ws = _block_weights(cin, width, cout, case != 'identity', seed=53)
    want = jfused_bottleneck(jnp.asarray(x), *[
        None if a is None else jnp.asarray(a) for a in ws], interpret=True)
    tws = [None if a is None else _t(a) for a in ws]
    blk = prepare_resblock(dict(zip(BLOCK_KEYS, tws)), torch.float32)
    before = fused_bottleneck.launches
    got = fused_bottleneck_prepared(_t(x), blk)      # CPU: the plain version
    assert fused_bottleneck.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  fused_bottleneck(_t(x), *tws).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('width', [8, 40, 64, 128])
def test_prepare_resblock_layout_undone_gives_the_folded_weights(width):
    """prepare_resblock's tuple, read back in the kernels' layout (w1
    [ci][co], w2 [tap][ci][co], w3 and wd [ci][co]) and widened to f32,
    gives the folded weights rounded to the dtype; biases stay f32 and
    exact; no downsample gives None twice. K5's prepare_block is the same
    function."""
    from kgdet_tpu_torch.ops.stem_kernels import prepare_block
    assert prepare_block is prepare_resblock
    for ds, cin, cout in ((True, 24, 72), (False, 72, 72)):
        ws = [None if a is None else _t(a)
              for a in _block_weights(cin, width, cout, ds, seed=width)]
        folded = dict(zip(BLOCK_KEYS, ws))
        for dtype in (torch.float32, torch.bfloat16):
            got = prepare_resblock(folded, dtype)
            assert len(got) == len(BLOCK_KEYS)
            for k, p in zip(BLOCK_KEYS, got):
                if folded[k] is None:
                    assert p is None
                    continue
                assert p.is_contiguous()
                assert p.dtype == (dtype if k[0] == 'w' else torch.float32)
            w1, b1, w2, b2, w3, b3, wd, bd = got
            back = {'w1': w1.reshape(cin, width),
                    'w2': w2.reshape(9, width, width).reshape(
                        3, 3, width, width),
                    'w3': w3.reshape(width, cout), 'b1': b1, 'b2': b2,
                    'b3': b3}
            assert torch.equal(w2.reshape(9, width, width)[4],
                               folded['w2'][1, 1].to(dtype))
            if ds:
                back.update(wd=wd.reshape(cin, cout), bd=bd)
            for k, v in back.items():
                want = folded[k].to(dtype).float() if k[0] == 'w' \
                    else folded[k]
                assert torch.equal(v.float(), want), k


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


def _prefix_net():
    """A one-stage ResNet-50 with a frozen prefix and BN statistics away
    from the identity, so a fold that missed one would show."""
    from kgdet_tpu_torch.models.layers import FrozenBatchNorm
    from kgdet_tpu_torch.models.resnet import ResNet
    net = ResNet(depth=50, num_stages=1, out_indices=(0,), frozen_stages=1)
    gen = torch.Generator().manual_seed(3)
    net.init_weights(gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.weight.numel()
                m.weight.copy_(0.5 + torch.rand(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
    return net


def test_prefix_weights_are_kept_once_per_dtype():
    """ResNet.prefix_weights: the same tensors on every call, per dtype,
    equal to a fresh fold and pack; dropped by load_state_dict, an in-place
    change of a stem, bn1 or layer1 tensor, and .to(); the plain prefix from
    the kept weights equal to stem_layer1_ref on Bottleneck.folded()
    weights, bit for bit, and so is the CPU route of the prepared chain."""
    from kgdet_tpu_torch.ops.resblock import fold_bn
    from kgdet_tpu_torch.ops.stem_kernels import BLOCK_KEYS, \
        pack_stem_weight
    net = _prefix_net()

    def fresh():
        sw, sb = fold_bn(net.conv1.weight.permute(2, 3, 1, 0),
                         net.bn1.weight, net.bn1.bias, net.bn1.running_mean,
                         net.bn1.running_var, net.bn1.eps)
        return sw.detach(), sb.detach(), [
            {k: v.detach() for k, v in blk.folded().items()}
            for blk in net.layer1]

    def assert_fresh(kept, dtype):
        (ksw, ksb), kblocks = kept[0]
        stem, blocks = kept[1]
        sw, sb, fb = fresh()
        assert torch.equal(ksw, sw) and torch.equal(ksb, sb)
        assert torch.equal(stem[0], sw.to(dtype)) and stem[1].dtype == \
            torch.float32 and torch.equal(stem[1], sb)
        want_k = pack_stem_weight(sw) if dtype == torch.bfloat16 \
            else sw.to(dtype)
        assert stem[2].is_contiguous() and torch.equal(stem[2], want_k)
        for kb, pb, want in zip(kblocks, blocks, fb):
            assert sorted(kb) == sorted(want)
            for i, k in enumerate(BLOCK_KEYS):
                if k not in want:
                    assert pb[i] is None
                    continue
                assert torch.equal(kb[k], want[k])
                dt = dtype if k[0] == 'w' else torch.float32
                assert pb[i].dtype == dt and pb[i].is_contiguous()
                assert torch.equal(pb[i], want[k].to(dt))

    kept = net.prefix_weights(torch.float32)
    assert net.prefix_weights(torch.float32)[1][0] is kept[1][0]
    assert_fresh(kept, torch.float32)
    half = net.prefix_weights(torch.bfloat16)
    assert half[1][0][2].shape == (64, 176)
    assert half[0] is kept[0]                 # one fold for both dtypes
    assert net.prefix_weights(torch.bfloat16)[1][1][0][0] is half[1][1][0][0]
    assert_fresh(half, torch.bfloat16)

    x = torch.randn(1, 40, 24, 3, generator=torch.Generator().manual_seed(4))
    sw, sb, fb = fresh()
    want = stem_layer1_ref(x, sw, sb, fb)
    net.plain_prefix = True
    assert torch.equal(net.frozen_prefix(x), want)
    net.plain_prefix = False                  # the prepared chain on a CPU
    assert torch.equal(net.frozen_prefix(x), want)

    changes = [lambda: net.load_state_dict(net.state_dict()),
               lambda: net.conv1.weight.add_(0.01),
               lambda: net.bn1.running_var.mul_(1.5),
               lambda: net.layer1[2].bn3.bias.sub_(0.1),
               lambda: net.layer1[0].downsample[0].weight.mul_(0.5)]
    for change in changes:
        kept = net.prefix_weights(torch.float32)
        with torch.no_grad():
            change()
        again = net.prefix_weights(torch.float32)
        assert again[0] is not kept[0] and again[1][0] is not kept[1][0]
        assert_fresh(again, torch.float32)
    kept = net.prefix_weights(torch.float32)
    net.to(torch.float64)
    assert net.prefix_weights(torch.float32)[1][0] is not kept[1][0]
    assert sorted(net.state_dict()) == sorted(_prefix_net().state_dict())


_PREFIX_SHIM = r'''
#include "prefix_index.h"
using K5Tile = kgdet::BlkTile<kgdet::kBlkT, kgdet::kBlkT>;
extern "C" void geometry(int* g) {
  const int v[] = {kgdet::kStemPH, kgdet::kStemPW, kgdet::kStemTH,
                   kgdet::kStemTW, kgdet::kStemMTiles, kgdet::kStemInTH,
                   kgdet::kStemInTW, kgdet::kStemRow, kgdet::kStemKPad,
                   kgdet::kBlkT, K5Tile::kHaloW, K5Tile::kHaloRows};
  for (int i = 0; i < 12; ++i) g[i] = v[i];
}
extern "C" void stem_offsets(int* rows, int* depth) {
  for (int m = 0; m < 16 * kgdet::kStemMTiles; ++m)
    rows[m] = kgdet::stem_row_offset(m);
  for (int k = 0; k < kgdet::kStemKPad; ++k)
    depth[k] = kgdet::stem_k_offset(k);
}
extern "C" void halo_rows(int* rows) {
  for (int tap = 0; tap < 9; ++tap)
    for (int m = 0; m < kgdet::kBlkT * kgdet::kBlkT; ++m)
      rows[tap * kgdet::kBlkT * kgdet::kBlkT + m] =
          kgdet::halo_row(m / kgdet::kBlkT, m % kgdet::kBlkT, tap,
                          K5Tile::kHaloW);
}
'''


@pytest.fixture(scope='module')
def prefix_index(tmp_path_factory):
    """csrc/prefix_index.h compiled for the host with g++ and loaded with
    ctypes: (geometry dict, the stem's GEMM row and depth offsets, conv2's
    operand rows a tap)."""
    import ctypes
    import shutil
    import subprocess

    from kgdet_tpu_torch.ops._build import CSRC
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    tmp = tmp_path_factory.mktemp('prefix_index')
    (tmp / 'shim.cpp').write_text(_PREFIX_SHIM)
    lib = tmp / 'libprefix.so'
    subprocess.run([gxx, '-O2', '-std=c++17', '-shared', '-fPIC',
                    f'-I{CSRC}', str(tmp / 'shim.cpp'), '-o', str(lib)],
                   check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.geometry.argtypes = [ctypes.c_void_p]
    cdll.stem_offsets.argtypes = [ctypes.c_void_p] * 2
    cdll.halo_rows.argtypes = [ctypes.c_void_p]
    g = np.zeros(12, np.int32)
    cdll.geometry(g.ctypes.data)
    geo = dict(zip(('PH', 'PW', 'TH', 'TW', 'MTILES', 'INTH', 'INTW', 'ROW',
                    'KPAD', 'BT', 'HALO', 'HALOROWS'), g.tolist()))
    rows = np.zeros(16 * geo['MTILES'], np.int32)
    depth = np.zeros(geo['KPAD'], np.int32)
    cdll.stem_offsets(rows.ctypes.data, depth.ctypes.data)
    halo = np.zeros((9, geo['BT'] ** 2), np.int32)
    cdll.halo_rows(halo.ctypes.data)
    return geo, rows, depth, halo


@pytest.mark.parametrize('tile', [(0, 0), (1, 2)])
def test_stem_gemm_index_math_matches_conv(prefix_index, tile):
    """K4's tensor-core body reads its A operand straight from the staged
    input tile at stem_row_offset(m) + stem_k_offset(k) (prefix_index.h)
    and multiplies by pack_stem_weight's (64, 176) layout: that product,
    built here from the header's offsets, equals F.conv2d's 7x7/2 stem on
    the tile's stem pixels (the corner tile, whose halo is zero padding,
    and an inner one). f32 sums of the same bf16 values in another order:
    atol 1e-5."""
    from kgdet_tpu_torch.ops.stem_kernels import pack_stem_weight
    geo, rows, depth, _ = prefix_index
    assert geo['ROW'] == 3 * geo['INTW'] and geo['KPAD'] == 176
    rng = np.random.RandomState(9)
    H, W = 64, 256
    x = _t(rng.randn(1, H, W, 3).astype(np.float32)).bfloat16().float()
    w = _t(rng.randn(7, 7, 3, 64).astype(np.float32) * .1)
    ty, tx = tile
    sy0, sx0 = 2 * geo['PH'] * ty - 1, 2 * geo['PW'] * tx - 1
    iy0, ix0 = 2 * sy0 - 3, 2 * sx0 - 3
    pad = 16
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad, pad, pad))
    staged = xp[0, iy0 + pad:iy0 + pad + geo['INTH'],
                ix0 + pad:ix0 + pad + geo['INTW']].reshape(-1)
    a = staged[torch.from_numpy((rows[:, None] + depth[None, :])
                                .astype(np.int64))]
    got = a @ pack_stem_weight(w).float().t()           # (576, 64)
    stem = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.bfloat16().float().permute(3, 2, 0, 1),
        stride=2, padding=3)[0].permute(1, 2, 0)        # (H/2, W/2, 64)
    stem = torch.nn.functional.pad(stem, (0, 0, 1, 1, 1, 1))
    m = np.arange(geo['TH'] * geo['TW'])
    sy, sx = sy0 + m // geo['TW'], sx0 + m % geo['TW']
    inside = (sy >= 0) & (sy < H // 2) & (sx >= 0) & (sx < W // 2)
    assert inside.any() and (ty or not inside.all())
    want = stem[sy[inside] + 1, sx[inside] + 1]
    np.testing.assert_allclose(got[:len(m)][inside].numpy(), want.numpy(),
                               atol=1e-5)


def test_bottleneck_conv2_rows_match_conv(prefix_index):
    """K5's conv2 reads tap t's operand rows at halo_row(oy, ox, t) of the
    conv1 tile (prefix_index.h): the sum over taps of those rows times the
    tap's (64, 64) weight equals F.conv2d's 3x3 on the 18x18 conv1 tile."""
    geo, _, _, halo = prefix_index
    n = geo['HALO']
    rng = np.random.RandomState(11)
    a1 = _t(rng.randn(n * n, 64).astype(np.float32))
    w2 = _t(rng.randn(3, 3, 64, 64).astype(np.float32) * .1)
    idx = torch.from_numpy(halo.astype(np.int64))
    got = sum(a1[idx[t]] @ w2.reshape(9, 64, 64)[t] for t in range(9))
    want = torch.nn.functional.conv2d(
        a1.reshape(1, n, n, 64).permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1))
    np.testing.assert_allclose(
        got.numpy(), want[0].permute(1, 2, 0).reshape(-1, 64).numpy(),
        atol=1e-4)
    assert halo.max() < geo['HALOROWS'] and halo.max() == n * n - 1


_BLK_SHIM = r'''
#include "prefix_index.h"
template <int TH, int TW> void geo(int* g) {
  using T = kgdet::BlkTile<TH, TW>;
  const int v[] = {TH, TW, T::kPix, T::kHaloW, T::kHaloPix, T::kHaloRows,
                   T::kMaxSlices};
  for (int i = 0; i < 7; ++i) g[i] = v[i];
}
extern "C" void blk_geometry(int t, int* g) {
  if (t == 0) geo<16, 16>(g);
  else if (t == 1) geo<8, 16>(g);
  else geo<8, 8>(g);
}
extern "C" int blk_tile(int width, int cout) {
  return kgdet::blk_tile(width, cout);
}
extern "C" int blk_tile_smem(int t, int width) {
  return kgdet::blk_tile_smem(t, width);
}
extern "C" int blk_ld(int width) { return kgdet::blk_ld(width); }
extern "C" int halo_row(int oy, int ox, int tap, int halo_w) {
  return kgdet::halo_row(oy, ox, tap, halo_w);
}
extern "C" int blk_schedule(int nc, int ns, int nout, int ds, int* out,
                            int cap) {
  kgdet::BlkStep st{kgdet::kConv1, 0, 0, 0};
  int n = 0;
  for (; st.phase != kgdet::kDone && n < cap; ++n) {
    const int v[] = {st.phase, st.out, st.tap, st.in};
    for (int i = 0; i < 4; ++i) out[4 * n + i] = v[i];
    st = kgdet::blk_next(st, nc, ns, nout, ds != 0);
  }
  return n;
}
'''


@pytest.fixture(scope='module')
def blk_index(tmp_path_factory):
    """The bottleneck body's helpers of csrc/prefix_index.h (tiles, shared
    memory, conv2's rows, the schedule) compiled for the host with g++:
    (ctypes library, {tile: geometry dict}, schedule(nc, ns, nout, ds) as
    an (steps, 4) array of phase, output slice, tap, input slice: blk_next
    walked from the first step to kDone)."""
    import ctypes
    import shutil
    import subprocess

    from kgdet_tpu_torch.ops._build import CSRC
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    tmp = tmp_path_factory.mktemp('blk_index')
    (tmp / 'shim.cpp').write_text(_BLK_SHIM)
    lib = tmp / 'libblk.so'
    subprocess.run([gxx, '-O2', '-std=c++17', '-shared', '-fPIC',
                    f'-I{CSRC}', str(tmp / 'shim.cpp'), '-o', str(lib)],
                   check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.blk_geometry.argtypes = [ctypes.c_int, ctypes.c_void_p]
    cdll.blk_schedule.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p,
                                                        ctypes.c_int]
    geos = {}
    for t in range(3):
        g = np.zeros(7, np.int32)
        cdll.blk_geometry(t, g.ctypes.data)
        geos[t] = dict(zip(('TH', 'TW', 'PIX', 'HALOW', 'HALOPIX',
                            'HALOROWS', 'MAXSLICES'), g.tolist()))

    def schedule(nc, ns, nout, ds):
        cap = 4096
        out = np.zeros((cap, 4), np.int32)
        n = cdll.blk_schedule(nc, ns, nout, ds, out.ctypes.data, cap)
        assert n < cap
        return out[:n]
    return cdll, geos, schedule


def _loop_nest(nc, ns, nout, ds):
    """The bottleneck body's loops in the order the kernel runs them
    (csrc/prefix_mma.cuh::bottleneck_mma_kernel): conv1, conv2, conv3 and
    the downsample, as (phase, output slice, tap, input slice)."""
    steps = [(0, j, 0, c) for j in range(ns) for c in range(nc)]
    steps += [(1, j, tap, i) for j in range(ns) for tap in range(9)
              for i in range(ns)]
    for n in range(nout):
        steps += [(2, n, 0, i) for i in range(ns)]
        steps += [(3, n, 0, c) for c in range(nc)] if ds else []
    return steps


@pytest.mark.parametrize('nc,ns,nout,ds', [
    (1, 1, 4, True), (4, 1, 4, False),    # K5's layer1 blocks, width 64
    (8, 2, 8, False), (4, 2, 8, True),    # width 128
    (1, 7, 2, True), (3, 3, 1, False),    # width 448, 192
])
def test_bottleneck_schedule_matches_the_loop_nest(blk_index, nc, ns, nout,
                                                   ds):
    """blk_next, which names the step whose slices the kernel fetches
    next, walks from the first step to kDone in the order of the kernel's
    loops; at width 64 that is K5's schedule of nc + 9 + (Cout / 64) *
    per_n steps."""
    _, _, schedule = blk_index
    got = [tuple(r) for r in schedule(nc, ns, nout, int(ds)).tolist()]
    assert got == _loop_nest(nc, ns, nout, ds)
    if ns == 1:
        assert len(got) == nc + 9 + nout * (1 + (nc if ds else 0))


def test_bottleneck_tiles_and_shared_memory(blk_index):
    """Each tile's geometry, the shared memory of a1, a2 and the two ring
    stages at every width, and the tile the body takes: 16x16 for K5's
    shapes (width 64, Cout a multiple of 64), else the first of 8x16 and
    8x8 that fits 227 KB (to width 192 and 448; none above). A tile's
    kMaxSlices is the most 64-channel slices of the width that fit it: one
    for 16x16, whose kernel fixes width and Cout's masks at compile time."""
    lib, geos, _ = blk_index
    for t, (th, tw) in enumerate(((16, 16), (8, 16), (8, 8))):
        g = geos[t]
        assert (g['TH'], g['TW'], g['PIX'], g['HALOW']) == \
            (th, tw, th * tw, tw + 2)
        assert g['HALOPIX'] == (th + 2) * (tw + 2)
        assert g['HALOROWS'] == -(-g['HALOPIX'] // 16) * 16
        for width in range(8, 1032, 8):
            assert (lib.blk_tile_smem(t, width) <= 232448) == \
                (-(-width // 64) <= g['MAXSLICES'])
    assert [g['MAXSLICES'] for g in geos.values()] == [1, 3, 7]
    assert lib.blk_tile_smem(0, 64) == 200448       # K5's tile
    for width in range(8, 520, 8):
        ld = -(-width // 64) * 64 + 8
        assert lib.blk_ld(width) == ld
        sizes = [2 * ((g['HALOROWS'] + g['PIX']) * ld
                      + 2 * (g['HALOROWS'] + 64) * 72) for g in geos.values()]
        assert [lib.blk_tile_smem(t, width) for t in range(3)] == sizes
        fits = [t for t in (1, 2) if sizes[t] <= 232448]
        for cout in (64, 256, 72):
            k5 = width == 64 and cout % 64 == 0
            want = 0 if k5 else fits[0] if fits else -1
            assert lib.blk_tile(width, cout) == want
            assert want == (0 if k5 else 1 if width <= 192
                            else 2 if width <= 448 else -1)


def _emulate_bottleneck(blk_index, t, x, w1, b1, w2, b2, w3, b3, wd, bd):
    """The tensor-core body's arithmetic in f32, block by block on tile t,
    from the header's helpers alone: every step of the decoded schedule is
    one 64 x 64 weight slice, zero past Cin, the width or Cout, as the
    kernel's fetches fill it; conv1 runs over the halo rows, 0 outside the
    image and in the width's padding; conv2 reads its rows at halo_row; an
    epilogue runs where the next step starts another output slice."""
    lib, geos, schedule = blk_index
    g = geos[t]
    th, tw, hw = g['TH'], g['TW'], g['HALOW']
    B, H, W, cin = x.shape
    width, cout = w1.shape[1], w3.shape[1]
    ds = wd is not None
    nc, ns, nout = -(-cin // 64), -(-width // 64), -(-cout // 64)

    def block(m, r, c):            # the zero-filled 64 x 64 slice of m
        out = torch.zeros(64, 64)
        v = m[64 * r:64 * r + 64, 64 * c:64 * c + 64]
        out[:v.shape[0], :v.shape[1]] = v
        return out

    def chans(v, n):               # a vector zero-padded to n slices
        return torch.nn.functional.pad(v, (0, 64 * n - v.shape[-1]))
    steps = schedule(nc, ns, nout, int(ds)).tolist()
    w2t = w2.reshape(9, width, width)
    hp = np.arange(g['HALOROWS'])
    rows = torch.from_numpy(np.array(
        [[lib.halo_row(m // tw, m % tw, tap, hw) for m in range(g['PIX'])]
         for tap in range(9)], np.int64))
    out = torch.zeros(B, H, W, cout)
    for b in range(B):
        for h0 in range(0, H, th):
            for w0 in range(0, W, tw):
                gy, gx = h0 - 1 + hp // hw, w0 - 1 + hp % hw
                inside = torch.from_numpy(
                    (hp < g['HALOPIX']) & (gy >= 0) & (gy < H) & (gx >= 0)
                    & (gx < W))
                xh = torch.zeros(g['HALOROWS'], 64 * nc)
                xh[inside, :cin] = x[b, gy[inside.numpy()],
                                     gx[inside.numpy()]]
                m = np.arange(g['PIX'])
                oy, ox = h0 + m // tw, w0 + m % tw
                ok = (oy < H) & (ox < W)
                xt = torch.zeros(g['PIX'], 64 * nc)
                xt[torch.from_numpy(ok), :cin] = x[b, oy[ok], ox[ok]]
                a1 = torch.zeros(g['HALOROWS'], 64 * ns)
                a2 = torch.zeros(g['PIX'], 64 * ns)
                acc = 0
                for k, (phase, o, tap, i) in enumerate(steps):
                    if phase == 0:
                        acc = acc + xh[:, 64 * i:64 * i + 64] @ block(w1, i, o)
                    elif phase == 1:
                        acc = acc + a1[rows[tap], 64 * i:64 * i + 64] \
                            @ block(w2t[tap], i, o)
                    elif phase == 2:
                        acc = acc + a2[:, 64 * i:64 * i + 64] @ block(w3, i, o)
                    else:
                        acc = acc + xt[:, 64 * i:64 * i + 64] @ block(wd, i, o)
                    nxt = steps[k + 1] if k + 1 < len(steps) else (9, -1, 0, 0)
                    if (min(nxt[0], 2), nxt[1]) == (min(phase, 2), o):
                        continue
                    cols = slice(64 * o, 64 * o + 64)
                    if phase == 0:
                        v = torch.relu(acc + chans(b1, ns)[cols])
                        live = torch.arange(64 * o, 64 * o + 64) < width
                        a1[:, cols] = v * inside[:, None] * live
                    elif phase == 1:
                        live = torch.arange(64 * o, 64 * o + 64) < width
                        a2[:, cols] = torch.relu(
                            acc + chans(b2, ns)[cols]) * live
                    else:
                        ident = chans(bd, nout)[cols] if ds \
                            else chans(xt, nout)[:, cols]
                        y = torch.relu(acc + chans(b3, nout)[cols] + ident)
                        n = min(64, cout - 64 * o)
                        out[b, oy[ok], ox[ok], 64 * o:64 * o + n] = \
                            y[torch.from_numpy(ok), :n]
                    acc = 0
    return out


@pytest.mark.parametrize('t,H,W,cin,width,cout,ds', [
    (0, 18, 20, 72, 64, 128, True),    # 16x16, K5's instance, Cin off 64
    (1, 9, 7, 16, 40, 16, False),      # 8x16, a width off the slice
    (1, 10, 19, 24, 128, 136, True),   # two slices, Cout off the slice
    (2, 11, 9, 64, 136, 64, False),    # 8x8, three slices, split columns
])
def test_bottleneck_body_schedule_matches_plain(blk_index, t, H, W, cin,
                                                width, cout, ds):
    """The body's schedule, tiles and conv2 rows (prefix_index.h through
    g++), run as the kernel runs them in f32 (_emulate_bottleneck), equal
    the plain version at each tile size within 1e-5 of the output's scale
    (summation order only), ragged tiles, halos
    outside the image and channel padding included; the first and last
    rows of the image at +5 and -5 and relu(b1) far from zero, so a halo
    or a padded channel holding relu(b1) instead of 0 would show."""
    rng = np.random.RandomState(60 + t)
    x = rng.randn(2, H, W, cin).astype(np.float32)
    x[:, 0], x[:, -1] = 5.0, -5.0
    ws = _block_weights(cin, width, cout, ds, seed=61 + t)
    ws[1] = np.abs(ws[1]) + 1.0
    tws = [None if a is None else _t(a) for a in ws]
    got = _emulate_bottleneck(blk_index, t, _t(x), *tws)
    want = bottleneck_reference(_t(x), *tws)
    # f32 sums in another order, of outputs up to some 30
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize('t', [0, 1, 2])
def test_bottleneck_conv2_rows_match_conv_at_each_tile(blk_index, t):
    """conv2's rows at halo_row(m / TW, m % TW, tap, TW + 2) of each tile's
    conv1 tile, times the tap's weight, summed over taps and the width's
    two slices, equal F.conv2d's 3x3 on that conv1 tile."""
    lib, geos, _ = blk_index
    g = geos[t]
    th, tw, hw = g['TH'], g['TW'], g['HALOW']
    width = 128
    rng = np.random.RandomState(12 + t)
    a1 = _t(rng.randn(g['HALOROWS'], width).astype(np.float32))
    w2 = _t(rng.randn(3, 3, width, width).astype(np.float32) * .1)
    rows = torch.from_numpy(np.array(
        [[lib.halo_row(m // tw, m % tw, tap, hw) for m in range(g['PIX'])]
         for tap in range(9)], np.int64))
    got = sum(a1[rows[tap], 64 * i:64 * i + 64]
              @ w2.reshape(9, width, width)[tap, 64 * i:64 * i + 64]
              for tap in range(9) for i in range(2))
    tile = a1[:g['HALOPIX']].reshape(1, th + 2, hw, width)
    want = torch.nn.functional.conv2d(tile.permute(0, 3, 1, 2),
                                      w2.permute(3, 2, 0, 1))
    np.testing.assert_allclose(
        got.numpy(), want[0].permute(1, 2, 0).reshape(-1, width).numpy(),
        atol=1e-4)
    assert rows.max() == g['HALOPIX'] - 1


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
