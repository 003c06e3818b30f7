"""The port's CUDA kernels against their plain versions at edge shapes.

Needs a CUDA card and nvcc; every test skips, in its fixture, without one.
The main-path shapes are checked by chip_smoke.py; these cases cover ragged
tiles: pixel counts, channel counts and image sizes that are not multiples
of the kernels' tile sizes, maps under 2x2, taps that are all out of bounds
or all on one pixel, the in-kernel index math of K1, K2, K3 and K6 on a grid
of boundary positions, both bodies of K1 (tensor cores, FMA) and of K3
(shared-memory slab in one band and in several, global atomics), branch maps
in two storages, the wrappers' shape checks,
the relative-offset entries at stride 2, the autograd Functions over K6 and
K3, and the ResNet per-block route (K8) against the chain (K4+K5). f32
tolerance rtol 1e-5, atol 1e-4 (chip_smoke.py's); K3's gradient map is
summed with f32 atomics in an order that changes from run to run, which that
tolerance covers. Imports no JAX, so it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import pytest
import torch

from kgdet_tpu_torch.ops import deform
from kgdet_tpu_torch.ops import deform_kernels as dk
from kgdet_tpu_torch.ops import resblock as rb
from kgdet_tpu_torch.ops import stem_kernels as sk

pytestmark = pytest.mark.gpu
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


def _positions(gen, B, P, K, H, W, kind):
    if kind == 'outside':       # every corner of every tap out of bounds
        return torch.full((B, P, K, 2), -7.5).cuda()
    if kind == 'one_pixel':     # every tap inside one 2x2 cell
        return torch.rand((B, P, K, 2), generator=gen).cuda() * 0.9 + 1.0
    pos = torch.rand((B, P, K, 2), generator=gen).cuda() \
        * torch.tensor([H + 4.0, W + 4.0], device='cuda') - 2.0
    pos[:, ::3, 0] = pos[:, ::3, 0].round()     # integer rows, border too
    pos[:, 1::5, :, 1] = pos[:, 1::5, :, 1].round()
    return pos


SAMPLING_CASES = [
    (5, 7, 12, 35, (2, 3), 'mixed'),       # C off the 16-byte pack (both)
    (5, 7, 20, 35, (2, 3), 'mixed'),       # f32 packs, bf16 does not
    (9, 6, 64, 130, (4, 9), 'mixed'),      # P*K crosses many block tiles
    (1, 5, 32, 20, (3,), 'mixed'),         # one-row map: padded to 2 rows
    (6, 6, 32, 40, (2, 2), 'outside'),     # all taps out of bounds
    (4, 4, 64, 300, (9, 25), 'one_pixel'),  # atomics under contention
]


@pytest.mark.parametrize('H,W,C,P,taps,kind', SAMPLING_CASES)
def test_k2_edge_shapes(gen, H, W, C, P, taps, kind):
    K = sum(taps)
    cls_feat, pts_feat = _randn(gen, 2, H, W, C), _randn(gen, 2, H, W, C)
    pos = _positions(gen, 2, P, K, H, W, kind)
    before = dk.deform_sample_split.launches
    got = dk.deform_sample_split(cls_feat, pts_feat, pos, taps)
    assert dk.deform_sample_split.launches == before + 1
    want = dk.deform_sample_split_ref(cls_feat, pts_feat, pos, taps)
    assert len(got) == len(want) == len(taps)
    for (gc, gp), (wc, wp), t in zip(got, want, taps):
        assert gc.shape == gp.shape == (2, P, t, C) and gc.is_contiguous()
        torch.testing.assert_close(gc, wc, **TOL)
        torch.testing.assert_close(gp, wp, **TOL)
        if kind == 'outside':
            assert not gc.any() and not gp.any()
    c16, p16 = cls_feat.bfloat16(), pts_feat.bfloat16()
    got16 = dk.deform_sample_split(c16, p16, pos, taps)
    ref = dk.deform_sample_split_ref(c16.float(), p16.float(), pos, taps)
    plain16 = dk.deform_sample_split_ref(c16, p16, pos, taps)
    for g, r, p in zip(got16, ref, plain16):
        for i in range(2):
            assert g[i].dtype == torch.bfloat16
            assert (g[i].float() - r[i]).abs().max() <= \
                2 * (p[i].float() - r[i]).abs().max()


@pytest.mark.parametrize('H,W,C,P,taps,kind', SAMPLING_CASES)
def test_k3_edge_shapes(gen, H, W, C, P, taps, kind):
    K = sum(taps)
    feat = _randn(gen, 2, H, W, C)
    pos = _positions(gen, 2, P, K, H, W, kind)
    g = _randn(gen, 2, P, K, C)
    before = dk.deform_sample_bwd.launches
    gfeat, gpos = dk.deform_sample_bwd(feat, pos, g)
    assert dk.deform_sample_bwd.launches == before + 1
    wfeat, wpos = dk.deform_sample_bwd_ref(feat, pos, g)
    assert gfeat.shape == feat.shape and gpos.shape == pos.shape
    # sums of up to P*K terms: the tolerance scales with the largest sum
    scale = max(1.0, wfeat.abs().max().item())
    torch.testing.assert_close(gfeat, wfeat, rtol=1e-5, atol=1e-4 * scale)
    torch.testing.assert_close(gpos, wpos, rtol=1e-5,
                               atol=1e-4 * max(1.0, wpos.abs().max().item()))
    if kind == 'outside':
        assert not gfeat.any() and not gpos.any()
    f16, g16 = feat.bfloat16(), g.bfloat16()
    kf, kp = dk.deform_sample_bwd(f16, pos, g16)
    rf, rp = dk.deform_sample_bwd_ref(f16.float(), pos, g16.float())
    pf, pp = dk.deform_sample_bwd_ref(f16, pos, g16)
    assert kf.dtype == torch.bfloat16 and kp.dtype == pos.dtype
    # grad_feat is rounded once to bf16 by both: half an ulp of the sum
    assert (kf.float() - rf).abs().max() <= \
        max(2 * (pf.float() - rf).abs().max().item(), 1e-4 * scale)
    assert (kp - rp).abs().max() <= \
        max(2 * (pp - rp).abs().max().item(),
            1e-4 * max(1.0, rp.abs().max().item()))


@pytest.mark.parametrize('H,W,C,P,taps,kind', SAMPLING_CASES)
def test_k6_edge_shapes(gen, H, W, C, P, taps, kind):
    K = sum(taps)
    feat = _randn(gen, 2, H, W, C)
    pos = _positions(gen, 2, P, K, H, W, kind)
    before = dk.deform_sample_cols.launches
    got = dk.deform_sample_cols(feat, pos)
    assert dk.deform_sample_cols.launches == before + 1
    want = dk.deform_sample_cols_ref(feat, pos)
    assert got.shape == (2, P, K, C) and got.is_contiguous()
    torch.testing.assert_close(got, want, **TOL)
    if kind == 'outside':
        assert not got.any()
    f16 = feat.bfloat16()
    got16 = dk.deform_sample_cols(f16, pos)
    ref = dk.deform_sample_cols_ref(f16.float(), pos)
    plain16 = dk.deform_sample_cols_ref(f16, pos)
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - ref).abs().max() <= \
        2 * (plain16.float() - ref).abs().max()


def _boundary_positions(H, W):
    """(1, n, 1, 2): the grid of tests/test_torch_kernels.py's index-math
    test on both axes: every quarter step from -2.5 to size + 1.5, -0.0,
    -1, size - 1, size and +-1e9."""
    def axis(size):
        steps = torch.arange(-2.5, size + 1.5 + 1e-6, 0.25)
        return torch.cat([steps, torch.tensor(
            [-0.0, -1.0, size - 1.0, size, 1e9, -1e9])])
    ys, xs = torch.meshgrid(axis(H), axis(W), indexing='ij')
    return torch.stack([ys, xs], dim=-1).reshape(1, -1, 1, 2).cuda()


def _assert_gather_matches_plain(feats, pos, taps):
    """K6 on the first map and K2 on both against their plain versions: f32
    within TOL, bf16 within twice the plain version's error against an f32
    run."""
    for dtype in (torch.float32, torch.bfloat16):
        maps = [f.to(dtype) for f in feats]
        ref = [dk.deform_sample_cols_ref(m.float(), pos) for m in maps]
        plain = [dk.deform_sample_cols_ref(m, pos) for m in maps]
        got = [dk.deform_sample_cols(maps[0], pos)]
        split = dk.deform_sample_split(maps[0], maps[1], pos, taps)
        got += [torch.cat([pair[i] for pair in split], dim=2)
                for i in range(2)]
        for g, i in zip(got, (0, 0, 1)):
            assert g.dtype == dtype and g.shape == ref[i].shape
            if dtype == torch.float32:
                torch.testing.assert_close(g, ref[i], **TOL)
            else:
                assert (g.float() - ref[i]).abs().max() <= \
                    2 * (plain[i].float() - ref[i]).abs().max()


@pytest.mark.parametrize('H,W', [(6, 7), (2, 2), (1, 5), (4, 1), (1, 1)])
def test_gather_index_math_on_the_boundary_grid(gen, H, W):
    """The in-kernel index math of K6 and K2 where it can go wrong: every
    quarter step across every border, exact integers, -0.0, +-1e9 (no
    corner matches: zeros), on maps down to one row, one column and one
    pixel (zero-padded to 2x2 by the wrappers)."""
    feats = [_randn(gen, 1, H, W, 32), _randn(gen, 1, H, W, 32)]
    pos = _boundary_positions(max(H, 2), max(W, 2))
    far = pos.abs().amax(dim=-1) >= 1e9
    assert far.any()
    _assert_gather_matches_plain(feats, pos, (1,))
    assert not dk.deform_sample_cols(feats[0], pos)[far].any()
    # the same grid as the taps of a few pixels, cut into uneven columns
    n = pos.shape[1] // 12 * 12
    _assert_gather_matches_plain(feats, pos[:, :n].reshape(1, -1, 12, 2),
                                 (5, 1, 6))


def _assert_fused_matches_plain(feat, pos, w):
    """K1 against its plain version: f32 within TOL, bf16 within twice the
    plain version's error against an f32 run."""
    torch.testing.assert_close(dk.deform_conv_fused(feat, pos, w),
                               dk.deform_conv_fused_ref(feat, pos, w), **TOL)
    f16, w16 = feat.bfloat16(), w.bfloat16()
    got = dk.deform_conv_fused(f16, pos, w16)
    ref = dk.deform_conv_fused_ref(f16.float(), pos, w16.float())
    plain = dk.deform_conv_fused_ref(f16, pos, w16)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert (got.float() - ref).abs().max() <= \
        2 * (plain.float() - ref).abs().max()
    return got


def _assert_bwd_matches_plain(feat, pos, g):
    """K3 against its plain version, both outputs: f32 within rtol 1e-5 and
    atol 1e-4 of the largest sum (the atomics' order varies), bf16 within
    twice the plain version's error against an f32 run or that floor."""
    gfeat, gpos = dk.deform_sample_bwd(feat, pos, g)
    wfeat, wpos = dk.deform_sample_bwd_ref(feat, pos, g)
    assert gfeat.shape == feat.shape and gpos.shape == pos.shape
    for got, want in ((gfeat, wfeat), (gpos.float(), wpos.float())):
        torch.testing.assert_close(
            got, want, rtol=1e-5,
            atol=1e-4 * max(1.0, want.abs().max().item()))
    f16, g16 = feat.bfloat16(), g.bfloat16()
    kf, kp = dk.deform_sample_bwd(f16, pos, g16)
    rf, rp = dk.deform_sample_bwd_ref(f16.float(), pos, g16.float())
    pf, pp = dk.deform_sample_bwd_ref(f16, pos, g16)
    assert kf.dtype == torch.bfloat16 and kp.dtype == pos.dtype
    for got, plain, ref in ((kf, pf, rf), (kp, pp, rp)):
        floor = 1e-4 * max(1.0, ref.abs().max().item())
        assert (got.float() - ref.float()).abs().max() <= \
            max(2 * (plain.float() - ref.float()).abs().max().item(), floor)
    return gfeat, gpos


@pytest.mark.parametrize('H,W', [(6, 7), (2, 2), (1, 5), (4, 1), (1, 1)])
@pytest.mark.parametrize('C,F', [(32, 16), (12, 10)])
def test_k1_k3_index_math_on_the_boundary_grid(gen, H, W, C, F):
    """The in-kernel index math of K1 and K3 (forward and backward
    coefficients) on the grid of the gathers' test: every quarter step
    across every border, exact integers (where the backward takes the
    one-sided derivative), -0.0, +-1e9, on maps down to one pixel; with
    channel counts on the 16-byte pack (K1's tensor-core body in bf16, K3's
    slab body) and off it (the FMA body, the atomic body); positions in f32
    and in bf16."""
    feat = _randn(gen, 1, H, W, C)
    pos = _boundary_positions(max(H, 2), max(W, 2))
    n = pos.shape[1] // 12 * 12
    far = pos.abs().amax(dim=-1) >= 1e9
    assert far.any()
    for p in (pos, pos[:, :n].reshape(1, -1, 12, 2)):
        K = p.shape[2]
        w = _randn(gen, K, C, F, std=(K * C) ** -0.5)
        g = _randn(gen, 1, p.shape[1], K, C)
        _assert_fused_matches_plain(feat, p, w)
        gfeat, gpos = _assert_bwd_matches_plain(feat, p, g)
        assert torch.isfinite(gfeat).all() and torch.isfinite(gpos).all()
        p16 = p.bfloat16()
        torch.testing.assert_close(
            dk.deform_conv_fused(feat, p16, w),
            dk.deform_conv_fused_ref(feat, p16.float(), w), **TOL)
        kf, kp = dk.deform_sample_bwd(feat, p16, g)
        wf, wp = dk.deform_sample_bwd_ref(feat, p16, g)
        assert kp.dtype == torch.bfloat16
        torch.testing.assert_close(
            kf, wf, rtol=1e-5, atol=1e-4 * max(1.0, wf.abs().max().item()))
        torch.testing.assert_close(kp, wp, rtol=1e-2, atol=1e-2 * max(
            1.0, wp.float().abs().max().item()))
    # a tap at +-1e9 matches no corner: no gradient to its position
    assert not dk.deform_sample_bwd(
        feat, pos, _randn(gen, 1, pos.shape[1], 1, C))[1][far].any()


@pytest.mark.parametrize('H,W,C,F,P,K,kind', [
    (4, 4, 64, 72, 300, 9, 'one_pixel'),    # every tap in one 2x2 cell
    (6, 6, 32, 24, 40, 4, 'outside'),       # every tap out of bounds
    (5, 7, 12, 10, 35, 5, 'mixed'),         # C, F off the pack: FMA body
    (5, 7, 40, 136, 70, 3, 'mixed'),        # C off the 64-channel step,
                                            # F over one 128-column tile
    (9, 6, 64, 256, 4300, 2, 'mixed'),      # P large enough for 64-row tiles
])
def test_k1_bodies_and_tap_patterns(gen, H, W, C, F, P, K, kind):
    feat = _randn(gen, 2, H, W, C)
    pos = _positions(gen, 2, P, K, H, W, kind)
    w = _randn(gen, K, C, F, std=(K * C) ** -0.5)
    before = dk.deform_conv_fused.launches
    got = _assert_fused_matches_plain(feat, pos, w)
    assert dk.deform_conv_fused.launches == before + 2
    if kind == 'outside':
        assert not got.any()


@pytest.mark.parametrize('H,W,C,K,kind,body', [
    (25, 42, 64, 17, 'mixed', 'slab, three bands of 10 rows'),
    (25, 42, 72, 17, 'near', 'slab, the second slice 8 channels wide'),
    (64, 200, 16, 70, 'near', 'slab, 32 bands of 2 rows'),
    (64, 200, 16, 70, 'mixed', 'slab, 32 bands, taps anywhere'),
    (13, 21, 256, 17, 'near', 'slab, one band, fewer chunks than warps'),
    (25, 42, 64, 5, 'near', 'under 64 adds an address: atomics'),
    (2, 1000, 8, 17, 'mixed', 'a map row of 64 channels over 227 KB: '
                              'atomics'),
    (40, 800, 8, 200, 'near', 'one row a band, over 32 bands: atomics'),
    (25, 42, 12, 17, 'near', 'C off the pack: atomics'),
])
def test_k3_both_bodies(gen, H, W, C, K, kind, body):
    """The sampling backward's two bodies and the shapes at which the
    launcher changes between them (csrc/deform_bwd.cu: the slab from 64 adds
    an address of the map's gradient, 16 taps a pixel, where its bands fit);
    no shape is refused: what the slab does not take goes through global
    atomics. 'near' puts every tap within a few cells of its own pixel, so
    taps cross the bands' edges."""
    P = min(H * W, 3000)
    feat = _randn(gen, 2, H, W, C)
    if kind == 'near':
        idx = torch.arange(P)
        centre = torch.stack([idx // W, idx % W], dim=-1).float()
        pos = (centre.reshape(1, P, 1, 2) + 2.0 * torch.randn(
            (2, P, K, 2), generator=gen)).cuda()
    else:
        pos = _positions(gen, 2, P, K, H, W, kind)
    g = _randn(gen, 2, P, K, C)
    before = dk.deform_sample_bwd.launches
    _assert_bwd_matches_plain(feat, pos, g)
    assert dk.deform_sample_bwd.launches == before + 2, body


def test_k3_no_tap_and_all_taps_outside(gen):
    feat = _randn(gen, 2, 6, 6, 32)
    pos = _positions(gen, 2, 40, 4, 6, 6, 'outside')
    gfeat, gpos = dk.deform_sample_bwd(feat, pos, _randn(gen, 2, 40, 4, 32))
    assert not gfeat.any() and not gpos.any()
    before = dk.deform_sample_bwd.launches
    gfeat, gpos = dk.deform_sample_bwd(feat, pos[:, :0],
                                       _randn(gen, 2, 0, 4, 32))
    assert gfeat.shape == feat.shape and not gfeat.any()
    assert gpos.shape == (2, 0, 4, 2)
    assert dk.deform_sample_bwd.launches == before      # no tap, no launch


def test_served_weight_layout_is_kept_on_the_card(gen):
    """DeformConvWeight.tap_major in eval(): one tensor for every call, in
    the compute dtype, handed to K1 as it is (no copy in the wrapper)."""
    from kgdet_tpu_torch.models.kgdet_head import DeformConvWeight
    m = DeformConvWeight(32, 16, 3).cuda().eval()
    torch.nn.init.normal_(m.weight, generator=None)
    with torch.inference_mode():
        w = m.tap_major(torch.bfloat16)
        assert m.tap_major(torch.bfloat16) is w and w.is_contiguous()
        feat = _randn(gen, 1, 5, 5, 32).bfloat16()
        pos = _positions(gen, 1, 25, 9, 5, 5, 'mixed')
        got = dk.deform_conv_fused(feat, pos, w)
        want = dk.deform_conv_fused_ref(feat.float(), pos, w.float())
        plain = dk.deform_conv_fused_ref(feat, pos, w)
    assert (got.float() - want).abs().max() <= \
        2 * (plain.float() - want).abs().max()
    assert m.cpu().tap_major(torch.bfloat16) is not w


def test_gather_all_taps_on_one_pixel(gen):
    feats = [_randn(gen, 2, 4, 4, 64), _randn(gen, 2, 4, 4, 64)]
    pos = _positions(gen, 2, 300, 34, 4, 4, 'one_pixel')
    _assert_gather_matches_plain(feats, pos, (9, 25))


def test_k2_takes_two_storages_strides_and_bf16_positions(gen):
    """cls and pts maps that are views of different storages, one of them
    not contiguous, C off the 16-byte pack (the one-channel path), and
    positions in bf16 (the math still runs in f32)."""
    H, W, C, P, taps = 5, 7, 12, 35, (2, 3)
    wide = _randn(gen, 2, H, W, 2 * C + 3)
    cls_feat = wide[..., 3:3 + C]                       # strided view
    pts_feat = _randn(gen, 2, W, H, C).transpose(1, 2)  # another storage
    assert not cls_feat.is_contiguous() and not pts_feat.is_contiguous()
    pos = _positions(gen, 2, P, sum(taps), H, W, 'mixed').bfloat16()
    got = dk.deform_sample_split(cls_feat, pts_feat, pos, taps)
    want = dk.deform_sample_split_ref(cls_feat, pts_feat, pos, taps)
    for pair, wpair in zip(got, want):
        for g, w in zip(pair, wpair):
            torch.testing.assert_close(g, w, **TOL)
    torch.testing.assert_close(dk.deform_sample_cols(cls_feat, pos),
                               dk.deform_sample_cols_ref(cls_feat, pos),
                               **TOL)


def test_gather_refuses_what_it_does_not_take(gen):
    feat = _randn(gen, 1, 4, 4, 32)
    pos = _randn(gen, 1, 5, 9, 2)
    with pytest.raises(ValueError, match='columns'):    # nine columns
        dk.deform_sample_split(feat, feat, pos, (1,) * 9)
    before = dk.deform_sample_cols.launches
    assert dk.deform_sample_cols(feat, pos[:, :0]).shape == (1, 0, 9, 32)
    assert dk.deform_sample_cols.launches == before     # no tap, no launch


@pytest.mark.parametrize('stride', [1, 2])
def test_deform_sample_and_conv_on_the_card(gen, stride):
    """ops/deform.py::deform_sample / deform_conv on CUDA tensors (K6
    forward, K3 backward) against their plain route: values and the
    gradients of the map, the offsets and the weight; output pixel centres
    at ``stride`` times the output index."""
    H, W, C, K, F = 7, 9, 24, 5, 8
    Ho, Wo = -(-H // stride), -(-W // stride)
    leaves = [_randn(gen, 2, H, W, C), _randn(gen, 2, Ho, Wo, K, 2, std=2.0),
              _randn(gen, K, C, F, std=(K * C) ** -0.5)]
    mod = torch.rand((2, Ho, Wo, K), generator=gen).cuda()
    ct = _randn(gen, 2, Ho, Wo, F)

    def run(plain):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        out = deform.deform_conv(xs[0], xs[1], xs[2], modulation=mod,
                                 stride=stride, plain=plain)
        return [out, *torch.autograd.grad(out, xs, ct)]

    k6, k3 = dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches
    got = run(False)
    assert dk.deform_sample_cols.launches == k6 + 1
    assert dk.deform_sample_bwd.launches == k3 + 1
    for g, w in zip(got, run(True)):
        torch.testing.assert_close(
            g, w, rtol=1e-5, atol=1e-4 * max(1.0, w.abs().max().item()))


def test_fused_conv_function_on_the_card(gen):
    """deform_conv_fused under differentiation (the Function over K6 and
    K3) against the same Function over their plain versions, and against K1
    without a gradient."""
    C, F, H, W, K = 32, 16, 6, 5, 9
    P = H * W
    leaves = [_randn(gen, 2, H, W, C),
              _positions(gen, 2, P, K, H, W, 'mixed'),
              _randn(gen, K, C, F, std=(K * C) ** -0.5)]
    ct = _randn(gen, 2, P, F)

    def run(plain):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        out = dk.deform_conv_fused(*xs, plain=plain)
        return [out, *torch.autograd.grad(out, xs, ct)]

    k1, k6, k3 = (dk.deform_conv_fused.launches,
                  dk.deform_sample_cols.launches,
                  dk.deform_sample_bwd.launches)
    got = run(False)
    assert (dk.deform_conv_fused.launches, dk.deform_sample_cols.launches,
            dk.deform_sample_bwd.launches) == (k1, k6 + 1, k3 + 1)
    for g, w in zip(got, run(True)):
        torch.testing.assert_close(
            g, w, rtol=1e-5, atol=1e-4 * max(1.0, w.abs().max().item()))
    fused = dk.deform_conv_fused(*leaves)
    assert dk.deform_conv_fused.launches == k1 + 1
    torch.testing.assert_close(fused, got[0], **TOL)


def _block(gen, cin, width, cout, ds):
    ws = [_randn(gen, cin, width, std=cin ** -0.5), _randn(gen, width, std=.1),
          _randn(gen, 3, 3, width, width, std=(9 * width) ** -0.5),
          _randn(gen, width, std=.1),
          _randn(gen, width, cout, std=width ** -0.5),
          _randn(gen, cout, std=.1)]
    return ws + ([_randn(gen, cin, cout, std=cin ** -0.5),
                  _randn(gen, cout, std=.1)] if ds else [None, None])


@pytest.mark.parametrize('H,W,cin,width,cout,ds', [
    (16, 16, 8, 8, 16, True),       # the TPU kernel's own test shapes
    (16, 16, 16, 8, 16, False),
    (13, 21, 64, 64, 256, True),    # H, W off the 8x8 tile
    (13, 21, 256, 64, 256, False),
    (5, 3, 24, 40, 72, True),       # every channel count off its tile
    (9, 9, 128, 128, 128, False),   # width over one 64-channel tile
])
def test_k8_edge_shapes(gen, H, W, cin, width, cout, ds):
    x = torch.relu(_randn(gen, 2, H, W, cin))
    ws = _block(gen, cin, width, cout, ds)
    before = rb.fused_bottleneck.launches
    got = rb.fused_bottleneck(x, *ws)
    assert rb.fused_bottleneck.launches == before + 1
    want = rb.bottleneck_reference(x, *ws)
    torch.testing.assert_close(got, want.contiguous(), **TOL)
    x16 = x.bfloat16()
    got16 = rb.fused_bottleneck(x16, *ws)
    ref = rb.bottleneck_reference(x16.float(),
                                  *[None if w is None else
                                    w.bfloat16().float() if w.dim() > 1 else w
                                    for w in ws])
    plain16 = rb.bottleneck_reference(x16, *ws)
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - ref).abs().max() <= \
        2 * (plain16.float() - ref).abs().max()


def test_k8_single_tile_with_a_distinctive_border(gen):
    """One 8x8 tile whose halo lies wholly outside the image, first and last
    rows at +5 and -5: conv2 must see zeros there, not relu(b1)."""
    x = _randn(gen, 1, 8, 8, 8)
    x[:, 0], x[:, -1] = 5.0, -5.0
    ws = _block(gen, 8, 8, 16, True)
    ws[1] = ws[1].abs() + 1.0               # relu(b1) far from zero
    torch.testing.assert_close(rb.fused_bottleneck(x, *ws),
                               rb.bottleneck_reference(x, *ws).contiguous(),
                               **TOL)


def test_k8_agrees_with_k5_at_width_64(gen):
    x = torch.relu(_randn(gen, 2, 24, 40, 64))
    ws = _block(gen, 64, 64, 256, True)
    torch.testing.assert_close(rb.fused_bottleneck(x, *ws),
                               sk.frozen_bottleneck(x, *ws), **TOL)


def test_k8_refuses_what_it_does_not_take(gen):
    y = _randn(gen, 1, 8, 8, 64)
    with pytest.raises(ValueError, match='shared memory'):   # 344 KB of tiles
        rb.fused_bottleneck(y, *_block(gen, 64, 512, 64, False))
    with pytest.raises(ValueError):           # cin != cout, no downsample
        rb.fused_bottleneck(y, *_block(gen, 64, 64, 256, False))
    with pytest.raises(ValueError):           # width off the multiple of 8
        rb.fused_bottleneck(y, *_block(gen, 64, 12, 64, False))
    with pytest.raises(TypeError):            # f16 is not a kernel dtype
        rb.fused_bottleneck(y.half(), *_block(gen, 64, 64, 64, False))


def test_resnet_per_block_route_matches_the_chain(gen):
    """The backbone with prefix_pipeline=False (K8 per layer1 block) against
    the K4+K5 chain and the all-plain route, every stage output, f32."""
    from kgdet_tpu_torch.models.resnet import ResNet
    net = ResNet(depth=50, frozen_stages=1).cuda()
    net.init_weights(torch.Generator().manual_seed(1))
    x = _randn(gen, 1, 72, 104, 3)
    with torch.no_grad():
        chain = net(x)
        net.prefix_pipeline = False
        k8, k5 = rb.fused_bottleneck.launches, sk.frozen_bottleneck.launches
        per_block = net(x)
        assert rb.fused_bottleneck.launches == k8 + 3
        assert sk.frozen_bottleneck.launches == k5
        net.plain_prefix = True
        plain = net(x)
        assert rb.fused_bottleneck.launches == k8 + 3
    for got, a, b in zip(per_block, chain, plain):
        scale = b.abs().max().item()
        torch.testing.assert_close(got, a, rtol=1e-4, atol=1e-4 * scale)
        torch.testing.assert_close(got, b, rtol=1e-4, atol=1e-4 * scale)


def test_columns_dual_function_on_the_card(gen):
    """The autograd Function over K2 and K3 against the same Function over
    their plain versions: outputs and all five gradients, f32."""
    taps, C, F, H, W = (2, 3), 32, 16, 6, 5
    P, K = H * W, sum(taps)
    leaves = [_randn(gen, 2, H, W, C), _randn(gen, 2, H, W, C),
              _positions(gen, 2, P, K, H, W, 'mixed')]
    leaves += [_randn(gen, t, C, F, std=(t * C) ** -0.5)
               for t in taps + taps]
    ct = _randn(gen, 2, P, len(taps) * F), _randn(gen, 2, P, len(taps) * F)

    def run(plain):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        outs = dk.deform_columns_dual(xs[0], xs[1], xs[2], xs[3:5], xs[5:7],
                                      taps, plain=plain)
        grads = torch.autograd.grad(outs, xs, ct)
        return list(outs) + list(grads)

    k2, k3 = dk.deform_sample_split.launches, dk.deform_sample_bwd.launches
    got = run(False)
    assert dk.deform_sample_split.launches == k2 + 1
    assert dk.deform_sample_bwd.launches == k3 + 1
    for g, w in zip(got, run(True)):
        torch.testing.assert_close(
            g, w, rtol=1e-5, atol=1e-4 * max(1.0, w.abs().max().item()))


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
    feat = _randn(gen, 1, 4, 4, 32)
    pos = _randn(gen, 1, 5, 5, 2)
    with pytest.raises(ValueError):           # taps do not sum to K
        dk.deform_sample_split(feat, feat, pos, (2, 2))
    with pytest.raises(ValueError):           # cotangent in another dtype
        dk.deform_sample_bwd(feat, pos, _randn(gen, 1, 5, 5, 32).bfloat16())
    with pytest.raises(TypeError):
        dk.deform_sample_split(feat.half(), feat.half(), pos, (2, 3))
