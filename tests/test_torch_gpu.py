"""The port's CUDA kernels against their plain versions at edge shapes.

Needs a CUDA card and nvcc; every test skips, in its fixture, without one.
The main-path shapes are checked by chip_smoke.py; these cases cover ragged
tiles: pixel counts, channel counts and image sizes that are not multiples
of the kernels' tile sizes, K4 and K5 in f32 and bf16 with both bodies of
K5 (tensor cores, FMA), conv1 halos wholly outside the image, one kernel a
call of K4 and K5 on prepared weights and four for the ResNet's frozen
prefix, maps under 2x2, taps that are all out of bounds
or all on one pixel, the in-kernel index math of K1, K2, K3 and K6 on a grid
of boundary positions, both bodies of K1 (tensor cores, FMA) and of K3
(shared-memory slab in one band and in several, global atomics), branch maps
in two storages, the wrappers' shape checks,
the relative-offset entries at stride 2, the autograd Functions over K6 and
K3, K8 through both its entries with both bodies (tensor cores on each of
their three tiles, FMA), K8 and K5 bit for bit in bf16 at width 64, the
ResNet per-block route (K8) against the chain (K4+K5), K6 and K3 at the
DCN backbone's stride-2 shapes, at GA-Retina's P3 and at ResNeXt-101's
grouped DCN shapes (up to 1024 channels), the grouped DCN module, the DCN
cascade's served launch counts, one served SSD300 batch, RoIAlign on K6 /
K3 at Faster R-CNN's P2 and the C4 map, Faster R-CNN's served and trained
launch counts, RoIAlign on K6 / K3 at Mask R-CNN's mask RoIs and the mask
targets' 32-channel map, the mask targets on K6, Mask R-CNN's served
launch counts, and K9 (greedy NMS) against its plain loop bit for bit at
the served, RPN and edge shapes, one kernel a call, the cascade's
served decode in fewer than 150 device activities, and the served R-50
backbone with the FrozenBatchNorms of layers 2 to 4 folded into their
convs (launches, kernels and bf16 error against the unfolded path), and
K10, their epilogue, against its plain version bit for bit at edge shapes
and at every call of a served batch of each block family (DCN, the
context block, ResNeXt-101, HRNet, C4's res5). f32
tolerance rtol 1e-5, atol 1e-4 (chip_smoke.py's); K3's gradient map is
summed with f32 atomics in an order that changes from run to run, which that
tolerance covers. bf16: the kernel's error against the plain version in
f32 at most twice the plain version's own bf16 error. Imports no JAX, so it
also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""
import pytest
import torch

from kgdet_tpu_torch.ops import deform
from kgdet_tpu_torch.ops import deform_kernels as dk
from kgdet_tpu_torch.ops import nms, plain_kernels
from kgdet_tpu_torch.ops import resblock as rb
from kgdet_tpu_torch.ops import stem_kernels as sk
from kgdet_tpu_torch.tools.profile import device_profile
from tests.kernel_inputs import nms_boxes

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


def _assert_bf16_within_twice_plain(kernel, plain, x, ws):
    """The kernel on bf16 inputs (weights cast inside, as the wrappers do):
    its error against the plain version on the same values in f32 at most
    twice the plain version's own bf16 error."""
    x16 = x.bfloat16()
    got = kernel(x16, *ws)
    ref = plain(x16.float(), *[None if w is None else
                               w.bfloat16().float() if w.dim() > 1 else w
                               for w in ws])
    plain16 = plain(x16, *ws)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    assert (got.float() - ref).abs().max() <= \
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
    _assert_bf16_within_twice_plain(sk.stem_pool, sk.stem_pool_ref, x, [w, b])


@pytest.mark.parametrize('H,W,cin,cout,ds', [
    (13, 21, 64, 256, True),    # partial tiles on both edges
    (8, 16, 128, 128, False),   # identity path, Cout = 2 x 64
    (3, 5, 96, 192, True),      # Cin off the 64-channel slice
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
    _assert_bf16_within_twice_plain(sk.frozen_bottleneck,
                                    sk.frozen_bottleneck_ref, x, ws)


def _device_kernels(fn):
    """The names of the device activities (kernels, copies, fills) of one
    call of ``fn``, by torch.profiler; a recording that lost its device
    records is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if names:
            return names
    pytest.fail('the profiler recorded no device activity in five tries')


@pytest.mark.parametrize('H,W,cin,cout,ds,dtype,body', [
    (13, 21, 64, 256, True, torch.bfloat16, 'mma'),
    (20, 17, 256, 256, False, torch.bfloat16, 'mma'),
    (13, 21, 64, 256, True, torch.float32, 'fma'),
    (9, 11, 12, 64, True, torch.bfloat16, 'fma'),    # Cin off the 16 bytes
])
def test_k5_both_bodies(gen, H, W, cin, cout, ds, dtype, body):
    """The tensor-core body takes bf16 with Cin % 8 == 0; f32 and bf16 it
    does not take run the FMA body. Checked by the kernel's name on the
    device, and each against the plain version (f32: TOL; bf16: the 2x
    rule)."""
    x = torch.relu(_randn(gen, 2, H, W, cin))
    ws = _block(gen, cin, 64, cout, ds)
    xin = x.to(dtype)
    names = [n for n in _device_kernels(
        lambda: sk.frozen_bottleneck(xin, *ws)) if 'kgdet::' in n]
    assert len(names) == 1
    assert ('bottleneck_mma_kernel' in names[0]) == (body == 'mma')
    if dtype == torch.float32:
        torch.testing.assert_close(sk.frozen_bottleneck(x, *ws),
                                   sk.frozen_bottleneck_ref(x, *ws), **TOL)
    else:
        _assert_bf16_within_twice_plain(sk.frozen_bottleneck,
                                        sk.frozen_bottleneck_ref, x, ws)


@pytest.mark.parametrize('size,dtype', [(16, torch.bfloat16),
                                        (8, torch.float32)])
def test_k5_single_tile_with_a_distinctive_border(gen, size, dtype):
    """One tile of each body (16x16 tensor cores, 8x8 FMA) whose conv1 halo
    lies wholly outside the image, first and last rows at +5 and -5, with
    relu(b1) far from zero: conv2 must see zeros there, not relu(b1)."""
    x = _randn(gen, 1, size, size, 64)
    x[:, 0], x[:, -1] = 5.0, -5.0
    ws = _block(gen, 64, 64, 256, True)
    ws[1] = ws[1].abs() + 1.0
    if dtype == torch.float32:
        torch.testing.assert_close(sk.frozen_bottleneck(x, *ws),
                                   sk.frozen_bottleneck_ref(x, *ws), **TOL)
    else:
        _assert_bf16_within_twice_plain(sk.frozen_bottleneck,
                                        sk.frozen_bottleneck_ref, x, ws)


def test_prepared_prefix_is_one_kernel_a_call(gen):
    """Through the prepared entries, a K4 call and a K5 call are one kernel
    each and nothing else on the device, and the ResNet's frozen prefix on
    its kept weights is four: K4 and K5 x3."""
    from kgdet_tpu_torch.models.resnet import ResNet
    x = _randn(gen, 2, 64, 96, 3).bfloat16()
    stem = sk.prepare_stem(_randn(gen, 7, 7, 3, 64, std=.2),
                           _randn(gen, 64, std=.1), torch.bfloat16)
    names = _device_kernels(lambda: sk.stem_pool_prepared(x, stem))
    assert len(names) == 1 and 'stem_pool_mma_kernel' in names[0]
    y = sk.stem_pool_prepared(x, stem)
    blk = sk.prepare_block(dict(zip(sk.BLOCK_KEYS, _block(gen, 64, 64, 256,
                                                          True))),
                           torch.bfloat16)
    names = _device_kernels(lambda: sk.frozen_bottleneck_prepared(y, blk))
    assert len(names) == 1 and 'bottleneck_mma_kernel' in names[0]

    net = ResNet(depth=50, num_stages=1, out_indices=(0,),
                 frozen_stages=1).cuda()
    net.init_weights(torch.Generator().manual_seed(1))
    names = _device_kernels(lambda: net.frozen_prefix(x))
    assert len(names) == 4 and all('kgdet::' in n for n in names)
    assert sum('bottleneck_mma_kernel' in n for n in names) == 3


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
        with plain_kernels(plain):
            out = deform.deform_conv(xs[0], xs[1], xs[2], modulation=mod,
                                     stride=stride)
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
        with plain_kernels(plain):
            out = dk.deform_conv_fused(*xs)
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
    # the prepared entry: the same kernel on the same values
    for xin, want in ((x, got), (x16, got16)):
        blk = rb.prepare_resblock(dict(zip(rb.BLOCK_KEYS, ws)), xin.dtype)
        before = rb.fused_bottleneck.launches
        assert torch.equal(rb.fused_bottleneck_prepared(xin, blk), want)
        assert rb.fused_bottleneck.launches == before + 1


def _body(names):
    """The K8 body a profile's one kernel of the port names: 'fma', or the
    tensor-core body's tile as 'mma TH x TW'."""
    import re
    own = [n for n in names if 'kgdet::' in n]
    assert len(own) == 1, own
    if 'resblock_kernel' in own[0]:
        return 'fma'
    m = re.search(r'bottleneck_mma_kernel<(\d+), ?(\d+)>', own[0])
    assert m, own[0]
    return f'mma {m.group(1)} x {m.group(2)}'


@pytest.mark.parametrize('H,W,cin,width,cout,ds,dtype,body', [
    # the per-block route's shapes
    (13, 21, 64, 64, 256, True, torch.bfloat16, 'mma 16 x 16'),
    (20, 17, 256, 64, 256, False, torch.bfloat16, 'mma 16 x 16'),
    (5, 3, 24, 40, 72, True, torch.bfloat16, 'mma 8 x 16'),  # width, Cout
    (9, 11, 64, 64, 72, True, torch.bfloat16, 'mma 8 x 16'),  # Cout 72
    (9, 9, 128, 128, 128, False, torch.bfloat16, 'mma 8 x 16'),
    (11, 13, 64, 192, 128, True, torch.bfloat16, 'mma 8 x 16'),
    (10, 7, 32, 256, 64, True, torch.bfloat16, 'mma 8 x 8'),
    (7, 9, 64, 448, 64, False, torch.bfloat16, 'mma 8 x 8'),  # the widest
    (13, 21, 64, 64, 256, True, torch.float32, 'fma'),
    (6, 5, 16, 8, 12, True, torch.bfloat16, 'fma'),   # Cout off the 16 bytes
])
def test_k8_both_bodies(gen, H, W, cin, width, cout, ds, dtype, body):
    """bf16 with channel counts on the 16-byte pack and a width whose tiles
    fit takes the tensor-core body: K5's 16x16 instance at width 64 with
    Cout a multiple of 64, else 8x16 to width 192 and 8x8 to 448; f32 and
    bf16 it does not take run the FMA body. Checked by the kernel's name on
    the device (one kernel a prepared call), and each against the plain
    version (f32: TOL; bf16: the 2x rule)."""
    x = torch.relu(_randn(gen, 2, H, W, cin))
    ws = _block(gen, cin, width, cout, ds)
    xin = x.to(dtype)
    blk = rb.prepare_resblock(dict(zip(rb.BLOCK_KEYS, ws)), dtype)
    names = _device_kernels(lambda: rb.fused_bottleneck_prepared(xin, blk))
    assert len(names) == 1 and _body(names) == body
    if dtype == torch.float32:
        torch.testing.assert_close(rb.fused_bottleneck(x, *ws),
                                   rb.bottleneck_reference(x, *ws), **TOL)
    else:
        _assert_bf16_within_twice_plain(rb.fused_bottleneck,
                                        rb.bottleneck_reference, x, ws)


@pytest.mark.parametrize('cin,ds', [(64, True), (256, False)])
def test_k8_and_k5_are_one_bf16_body_at_width_64(gen, cin, ds):
    """At width 64 in bf16 K8 and K5 launch the same tensor-core body on
    one prepared block: bit-equal outputs, one kernel a call each."""
    x = torch.relu(_randn(gen, 2, 24, 40, cin)).bfloat16()
    blk = rb.prepare_resblock(
        dict(zip(rb.BLOCK_KEYS, _block(gen, cin, 64, 256, ds))),
        torch.bfloat16)
    assert torch.equal(rb.fused_bottleneck_prepared(x, blk),
                       sk.frozen_bottleneck_prepared(x, blk))
    for fn in (rb.fused_bottleneck_prepared, sk.frozen_bottleneck_prepared):
        names = _device_kernels(lambda: fn(x, blk))
        assert len(names) == 1 and _body(names) == 'mma 16 x 16'


@pytest.mark.parametrize('size,width,dtype', [
    (8, 8, torch.float32), (8, 8, torch.bfloat16), (16, 64, torch.bfloat16),
    (8, 40, torch.bfloat16), (8, 128, torch.bfloat16),
    (8, 256, torch.bfloat16)])
def test_k8_single_tile_with_a_distinctive_border(gen, size, width, dtype):
    """One tile whose halo lies wholly outside the image (f32: the FMA
    body's 8x8; bf16: the tensor-core body's 16x16 at width 64, 8x16 and
    8x8, with the width's padding at width 8 and 40), first and last rows
    at +5 and -5, relu(b1) far from zero: conv2 must see zeros there and in
    the padded channels, not relu(b1)."""
    x = _randn(gen, 1, size, size, 8)
    x[:, 0], x[:, -1] = 5.0, -5.0
    ws = _block(gen, 8, width, 64, True)
    ws[1] = ws[1].abs() + 1.0               # relu(b1) far from zero
    if dtype == torch.float32:
        torch.testing.assert_close(
            rb.fused_bottleneck(x, *ws),
            rb.bottleneck_reference(x, *ws).contiguous(), **TOL)
    else:
        _assert_bf16_within_twice_plain(rb.fused_bottleneck,
                                        rb.bottleneck_reference, x, ws)


def test_k8_agrees_with_k5_at_width_64(gen):
    """f32, where both run FMA tiles of the same order; in bf16 K5 runs on
    the tensor cores and each is held to its plain version instead."""
    x = torch.relu(_randn(gen, 2, 24, 40, 64))
    ws = _block(gen, 64, 64, 256, True)
    torch.testing.assert_close(rb.fused_bottleneck(x, *ws),
                               sk.frozen_bottleneck(x, *ws), **TOL)


def test_k8_refuses_what_it_does_not_take(gen):
    y = _randn(gen, 1, 8, 8, 64)
    with pytest.raises(ValueError, match='shared memory'):   # 344 KB of tiles
        rb.fused_bottleneck(y, *_block(gen, 64, 512, 64, False))
    with pytest.raises(ValueError, match='shared memory'):   # 228 KB, bf16
        rb.fused_bottleneck(y.bfloat16(), *_block(gen, 64, 512, 64, False))
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
        with plain_kernels():
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
        with plain_kernels(plain):
            outs = dk.deform_columns_dual(xs[0], xs[1], xs[2], xs[3:5],
                                          xs[5:7], taps)
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


# ------------------------------------------------- checkpoints on the card
# the tiny R-50 KGDet training config of tests/test_torch_runner.py, which
# imports it from here; the port's load_config reads its kgdet_tpu.config
# import as its own config module, so neither file needs JAX for it
CONFIG_TEXT = '''
import dataclasses

from kgdet_tpu.config import (
    BackboneConfig, DataConfig, HeadConfig, KGDetConfig, NeckConfig,
    OptimConfig, TestConfig)

_DATA = DataConfig(
    ann_file={ann!r}, img_prefix={prefix!r}, img_scale=(96, 64),
    max_gts=8, batch_size=2, flip_ratio=0.5, canvas_hw={canvases!r})

config = KGDetConfig(
    backbone=BackboneConfig(depth=50, frozen_stages=1),
    neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=64,
                    select_out=(2,), gn_groups=32),
    head=HeadConfig(num_classes=13, in_channels=64, feat_channels=64,
                    point_feat_channels=64, stacked_convs=1,
                    num_keypts=294, gn_groups=8),
    test=TestConfig(nms_pre=50, max_per_class=10, max_per_img=20,
                    score_thr=0.0),
    optim=OptimConfig(lr=1e-3, warmup_iters=2, total_epochs=2),
    train_data=_DATA, val_data=dataclasses.replace(_DATA, flip_ratio=0.0))
'''


def _tiny_cfg(root):
    """CONFIG_TEXT in bf16 on 8 PNGs written under ``root`` without OpenCV
    (landscape and portrait in turn, one garment each with its keypoints,
    COCO style): 4 steps of 2 an epoch on both canvases."""
    import json
    import os

    import numpy as np

    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.data.deepfashion2_meta import (
        CLASS_KEYPOINT_RANGES, NUM_KEYPOINTS)
    from kgdet_tpu_torch.data.image_io import write_png
    root = str(root)
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i in range(8):
        h, w = (120, 160) if i % 2 == 0 else (160, 120)
        write_png(os.path.join(root, f'{i}.png'),
                  rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        images.append({'id': i + 1, 'file_name': f'{i}.png', 'height': h,
                       'width': w})
        cat = int(rng.randint(1, 14))
        s, e = CLASS_KEYPOINT_RANGES[cat]
        kp = np.zeros((NUM_KEYPOINTS, 3))
        kp[s:e] = [30.0, 40.0, 2.0]
        anns.append({'id': i + 1, 'image_id': i + 1, 'category_id': cat,
                     'iscrowd': 0, 'bbox': [10.0, 20.0, 60.0, 50.0],
                     'area': 3000.0, 'keypoints': kp.reshape(-1).tolist(),
                     'num_keypoints': e - s})
    ann = os.path.join(root, 'ann.json')
    with open(ann, 'w') as f:
        json.dump({'images': images, 'annotations': anns, 'categories': [
            {'id': c, 'name': f'cls{c}'} for c in range(1, 14)]}, f)
    path = os.path.join(root, 'cfg.py')
    with open(path, 'w') as f:
        f.write(CONFIG_TEXT.format(ann=ann, prefix=root,
                                   canvases=((64, 96), (96, 64))))
    return load_config(path).replace(compute_dtype='bfloat16')


def test_checkpoint_from_the_card_loads_on_the_cpu_and_back(gen, tmp_path):
    """A train state saved from the card holds CPU tensors only, loads
    with weights_only=True into a model and an optimizer on the CPU, and
    from there back onto the card, every tensor unchanged."""
    from kgdet_tpu_torch.api import build_model
    from kgdet_tpu_torch.parallel.train import make_optimizer
    from kgdet_tpu_torch.utils.checkpoint import FILE, CheckpointManager
    cfg = _tiny_cfg(tmp_path)
    model = build_model(cfg).init_weights(0)
    opt, _ = make_optimizer(cfg, model, 10)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=gen).cuda()
    opt.step()
    mgr = CheckpointManager(str(tmp_path / 'card'))
    mgr.save(1, {'model': model.state_dict(), 'optimizer': opt.state_dict(),
                 'step': 1, 'epoch': 0})
    state = torch.load(str(tmp_path / 'card' / '1' / FILE),
                       weights_only=True)
    assert all(t.device.type == 'cpu' for t in state['model'].values())
    cpu = build_model(cfg, device='cpu')
    cpu.load_state_dict(state['model'])
    cpu_opt, _ = make_optimizer(cfg, cpu, 10)
    cpu_opt.load_state_dict(state['optimizer'])
    back_mgr = CheckpointManager(str(tmp_path / 'cpu'))
    back_mgr.save(1, {'model': cpu.state_dict(),
                      'optimizer': cpu_opt.state_dict()})
    back = back_mgr.restore(1)
    card = build_model(cfg)
    card.load_state_dict(back['model'])
    card_opt, _ = make_optimizer(cfg, card, 10)
    card_opt.load_state_dict(back['optimizer'])
    for (n, a), b in zip(model.state_dict().items(),
                         card.state_dict().values()):
        assert b.is_cuda and torch.equal(a, b), n
    for n, a in opt.state_dict()['momentum'].items():
        b = card_opt.state_dict()['momentum'][n]
        assert b.is_cuda and torch.equal(a, b), n


def test_loaded_model_serves_what_the_saved_model_served(gen, tmp_path):
    """init_detector(cfg, checkpoint) on the card, and a model that served
    other weights before load_state_dict (its kept frozen-prefix weights,
    ResNet.prefix_weights, then stale), serve the saved model's
    detections bit for bit through K4, K5 and K1."""
    from kgdet_tpu_torch.api import build_model, init_detector, \
        make_predict_fn
    from kgdet_tpu_torch.utils.checkpoint import save_params
    cfg = _tiny_cfg(tmp_path)
    canvas = (64, 96)
    batch = {'image': torch.randint(0, 256, (2, *canvas, 3),
                                    generator=gen).to(torch.uint8),
             'img_hw': torch.tensor([[64.0, 85.0], [60.0, 96.0]]),
             'scale_factor': torch.tensor([0.5333, 0.5])}
    saved = build_model(cfg).init_weights(3).eval()
    want = make_predict_fn(saved, cfg, canvas)(batch)
    save_params(str(tmp_path / 'p'), saved.state_dict())
    other = build_model(cfg).init_weights(4).eval()
    stale = make_predict_fn(other, cfg, canvas)
    before = stale(batch)
    k4, k5, k1 = (sk.stem_pool.launches, sk.frozen_bottleneck.launches,
                  dk.deform_conv_fused.launches)
    other.load_state_dict(saved.state_dict())
    loaded = init_detector(cfg, str(tmp_path / 'p')).model
    for got in (stale(batch), make_predict_fn(loaded, cfg, canvas)(batch)):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert not torch.equal(before['det_bboxes'], want['det_bboxes'])
    assert sk.stem_pool.launches == k4 + 2
    assert sk.frozen_bottleneck.launches == k5 + 6
    assert dk.deform_conv_fused.launches == k1 + 24


def test_runner_epoch_on_the_card(gen, tmp_path):
    """One Runner epoch at tiny size on the card: both canvases, one step
    function each on one optimizer, K2 2 / K3 2 / K4 1 / K5 3 a step,
    finite log records, a checkpoint that loads on the CPU."""
    import json

    from kgdet_tpu_torch.runner import Runner
    from kgdet_tpu_torch.utils.checkpoint import load_params
    runner = Runner(_tiny_cfg(tmp_path), work_dir=str(tmp_path / 'w'),
                    log_interval=2)
    runner.setup()
    assert runner.device.type == 'cuda'
    counts = [dk.deform_sample_split.launches, dk.deform_sample_bwd.launches,
              sk.stem_pool.launches, sk.frozen_bottleneck.launches]
    runner.train_epoch()
    steps = runner.steps_per_epoch
    assert runner.step == steps == 4
    assert sorted(runner._step_fns) == [(64, 96), (96, 64)]
    assert [dk.deform_sample_split.launches, dk.deform_sample_bwd.launches,
            sk.stem_pool.launches, sk.frozen_bottleneck.launches] == \
        [c + n * steps for c, n in zip(counts, (2, 2, 1, 3))]
    with open(tmp_path / 'w' / 'train_log.jsonl') as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2
    for r in recs:
        assert all(v == v and abs(v) != float('inf')
                   for v in r.values() if not isinstance(v, str))
    runner.save_checkpoint()
    state = load_params(str(tmp_path / 'w' / 'checkpoints' / '4'))
    for k, v in runner.model.state_dict().items():
        assert not state[k].is_cuda and torch.equal(state[k], v.cpu()), k


def _dcn_positions(gen, B, Ho, Wo, stride):
    """A DCN's taps: the 3x3 grid around each output pixel's centre
    (``stride`` times its index), moved by N(0, 0.5) cells."""
    ys, xs = torch.meshgrid(torch.arange(Ho), torch.arange(Wo),
                            indexing='ij')
    centre = stride * torch.stack([ys, xs], dim=-1).reshape(1, -1, 1, 2)
    grid = torch.tensor([(dy, dx) for dy in (-1, 0, 1)
                         for dx in (-1, 0, 1)]).reshape(1, 1, 9, 2)
    noise = 0.5 * torch.randn((B, Ho * Wo, 9, 2), generator=gen)
    return (centre + grid + noise).cuda()


@pytest.mark.parametrize('H,W,C', [(200, 336, 128), (50, 84, 512)])
def test_k6_k3_at_the_dcn_stride2_shapes(gen, H, W, C):
    """K6 and K3 against their plain versions at chip_smoke.py's phase 1
    DCN shapes (layer2.0 and layer4.0 of the DCN backbone at 800x1344,
    stride 2, 9 taps, P = H*W/4), batch 2: f32 within TOL (K3's sums
    within 1e-4 of the largest), bf16 within twice the plain version's
    error."""
    _check_k6_k3(gen, H, W, C, 2)


@pytest.mark.parametrize('H,W,C,stride', [(100, 168, 256, 1),
                                          (200, 336, 256, 2),
                                          (50, 84, 1024, 2)])
def test_k6_k3_at_the_ga_and_resnext_shapes(gen, H, W, C, stride):
    """K6 and K3 against their plain versions at chip_smoke.py's phase 13
    shapes, batch 2, 9 taps: GA-Retina's feature adaption on P3 (stride
    1) and ResNeXt-101 32x4d's grouped DCN blocks layer2.0 and layer4.0
    (stride 2; 1024 channels, the widest map they take); the bounds of
    test_k6_k3_at_the_dcn_stride2_shapes."""
    _check_k6_k3(gen, H, W, C, stride)


def test_grouped_dcn_module_on_the_card(gen):
    """DeformConv3x3 with 32 groups (ResNeXt) on the card, K6 forward and
    K3 backward, against the module on the plain versions: output and
    every gradient within 1e-4 of its scale in f32."""
    from kgdet_tpu_torch.models.resnet import DeformConv3x3
    conv = DeformConv3x3(256, 256, stride=2, groups=32).cuda()
    with torch.no_grad():
        conv.weight.copy_(_randn(gen, *conv.weight.shape) * 0.05)
    x = _randn(gen, 2, 256, 20, 34)
    off = _randn(gen, 2, 18, 10, 17) * 0.5

    def run(plain):
        leaves = [t.clone().requires_grad_() for t in (x, off)]
        with plain_kernels(plain):
            out = conv(*leaves)
        grads = torch.autograd.grad(out.square().sum(),
                                    leaves + [conv.weight])
        return [out, *grads]
    k6, k3 = dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches
    got = run(False)
    assert (dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches) \
        == (k6 + 1, k3 + 1)
    for a, b in zip(got, run(True)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * b.abs().max().item())


def _check_k6_k3(gen, H, W, C, stride):
    Ho, Wo = -(-H // stride), -(-W // stride)
    feat = _randn(gen, 2, H, W, C)
    pos = _dcn_positions(gen, 2, Ho, Wo, stride)
    g = _randn(gen, 2, Ho * Wo, 9, C)
    k6, k3 = dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches
    got = dk.deform_sample_cols(feat, pos)
    gfeat, gpos = dk.deform_sample_bwd(feat, pos, g)
    assert (dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches) \
        == (k6 + 1, k3 + 1)
    torch.testing.assert_close(got, dk.deform_sample_cols_ref(feat, pos),
                               **TOL)
    wfeat, wpos = dk.deform_sample_bwd_ref(feat, pos, g)
    torch.testing.assert_close(
        gfeat, wfeat, rtol=1e-5,
        atol=1e-4 * max(1.0, wfeat.abs().max().item()))
    torch.testing.assert_close(
        gpos, wpos, rtol=1e-5, atol=1e-4 * max(1.0, wpos.abs().max().item()))
    f16, g16 = feat.bfloat16(), g.bfloat16()
    ref = dk.deform_sample_cols_ref(f16.float(), pos)
    assert (dk.deform_sample_cols(f16, pos).float() - ref).abs().max() <= \
        2 * (dk.deform_sample_cols_ref(f16, pos).float() - ref).abs().max()
    kf, kp = dk.deform_sample_bwd(f16, pos, g16)
    rf, rp = dk.deform_sample_bwd_ref(f16.float(), pos, g16.float())
    pf, pp = dk.deform_sample_bwd_ref(f16, pos, g16)
    assert (kf.float() - rf).abs().max() <= max(
        2 * (pf.float() - rf).abs().max().item(),
        1e-4 * rf.abs().max().item())
    assert (kp - rp).abs().max() <= max(
        2 * (pp - rp).abs().max().item(), 1e-4 * rp.abs().max().item())


def test_dcn_cascade_served_launch_counts(gen):
    """The cascade config with dcn_stages=(1, 2, 3), served on the card at
    256x384, batch 1, test.score_thr 0: K1 12, K4 1, K5 3 and K6 13 (one
    a DCN block) a forward and K9 once in the decode, nothing else; finite
    detections."""
    import dataclasses
    import os

    from kgdet_tpu_torch.api import build_model, make_predict_fn
    from kgdet_tpu_torch.config import load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(
        root, 'configs', 'kgdet_moment_r50_fpn_1x_deepfashion2.py'))
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                   dcn_stages=(1, 2, 3)),
                      test=dataclasses.replace(cfg.test, score_thr=0.0))
    canvas = (256, 384)
    model = build_model(cfg).init_weights(0).eval()
    predict = make_predict_fn(model, cfg, canvas)
    batch = {'image': torch.randint(0, 256, (1, *canvas, 3),
                                    generator=gen).to(torch.uint8),
             'img_hw': torch.tensor([[256.0, 380.0]]),
             'scale_factor': torch.tensor([1.0])}
    wrappers = (dk.deform_conv_fused, sk.stem_pool, sk.frozen_bottleneck,
                dk.deform_sample_cols, dk.deform_sample_split,
                dk.deform_sample_bwd, rb.fused_bottleneck, nms.greedy_nms)
    before = [w.launches for w in wrappers]
    dets = predict(batch)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [12, 1, 3, 13, 0, 0, 0, 1]
    assert torch.isfinite(dets['det_bboxes']).all() and dets['valid'].any()


def test_ssd300_served_batch(gen):
    """configs/ssd300_vgg16_deepfashion2.py on the card, one batch of 2 at
    300x300: no port of a TPU kernel launched (none is on this path), K9
    once (the decode's NMS), detections finite and of the config's shapes
    (the dummy keypoint of width 3)."""
    import os

    from kgdet_tpu_torch.api import build_model, make_predict_fn
    from kgdet_tpu_torch.config import load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, 'configs',
                                   'ssd300_vgg16_deepfashion2.py'))
    model = build_model(cfg).init_weights(0).eval()
    wrappers = (dk.deform_conv_fused, sk.stem_pool, sk.frozen_bottleneck,
                dk.deform_sample_cols, dk.deform_sample_split,
                dk.deform_sample_bwd, rb.fused_bottleneck, nms.greedy_nms)
    before = [w.launches for w in wrappers]
    dets = make_predict_fn(model, cfg, (300, 300))({
        'image': torch.randint(0, 256, (2, 300, 300, 3),
                               generator=gen).to(torch.uint8),
        'img_hw': torch.tensor([[300.0, 300.0], [225.0, 300.0]]),
        'scale_factor': torch.tensor([0.5, 0.5])})
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [0, 0, 0, 0, 0, 0, 0, 1]
    assert dets['det_bboxes'].shape == (2, 200, 5)
    assert dets['det_kpts'].shape == (2, 200, 3)
    assert torch.isfinite(dets['det_bboxes']).all()


@pytest.mark.parametrize('H,W,C,stride,out,b', [
    (200, 336, 256, 4, 7, 2),       # Faster R-CNN's P2, 196 samples a RoI
    (50, 84, 1024, 16, 14, 1),      # the C4 map, 784 samples a RoI
])
def test_roi_align_on_k6_k3_at_the_rcnn_shapes(gen, H, W, C, stride, out,
                                               b):
    """ops/roi.py::roi_align on the card, one K6 launch forward and one K3
    backward, against its plain versions at chip_smoke.py's phase 1 RoI
    shapes, 1000 RoIs an image: f32 output within TOL and the map's
    gradient within 1e-4 of its largest value; bf16 output and gradient
    within twice the plain version's error (or 1e-4 of the largest
    gradient, the f32 atomics' order)."""
    from kgdet_tpu_torch.ops.roi import roi_align
    R = 1000
    xy = torch.rand((b, R, 2), generator=gen) \
        * torch.tensor([W * stride - 64.0, H * stride - 64.0])
    wh = 16.0 + torch.rand((b, R, 2), generator=gen) * 48 * stride / 4
    boxes = torch.cat([xy, xy + wh], -1).cuda()
    feat = _randn(gen, b, H, W, C)
    cot = _randn(gen, b, R, out, out, C)

    def run(dtype, plain):
        f = feat.to(dtype).requires_grad_(True)
        with plain_kernels(plain):
            y = roi_align(f, boxes, out, 1.0 / stride, 2)
        g, = torch.autograd.grad((y.float() * cot).sum(), f)
        return y.detach().float(), g.float()
    k6, k3 = dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches
    got = run(torch.float32, False)
    assert (dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches) \
        == (k6 + 1, k3 + 1)
    want = run(torch.float32, True)
    assert (dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches) \
        == (k6 + 1, k3 + 1)
    torch.testing.assert_close(got[0], want[0], **TOL)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5,
                               atol=1e-4 * want[1].abs().max().item())
    for k, p, w in zip(run(torch.bfloat16, False), run(torch.bfloat16, True),
                       want):
        assert (k - w).abs().max() <= max(2 * (p - w).abs().max().item(),
                                          1e-4 * w.abs().max().item())


def _two_stage_cfg(name):
    import dataclasses
    import os

    from kgdet_tpu_torch.config import load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, 'configs',
                                   f'{name}_1x_deepfashion2.py'))
    return cfg.replace(test=dataclasses.replace(cfg.test, score_thr=0.0))


def test_faster_rcnn_served_batch_and_step_launch_counts(gen):
    """configs/faster_rcnn_r50_fpn_1x_deepfashion2.py (bf16) on the card at
    256x384, batch 2: a served batch launches K4 1, K5 3, K6 5 (one a FPN
    level), K9 2 (the proposals, the detections) and nothing else, with
    finite detections; a train step through init_trainer launches K4 1,
    K5 3, K6 5, K3 5 and K9 1 (the proposals) with finite logs."""
    import numpy as np

    from kgdet_tpu_torch.api import build_model, init_trainer, \
        make_predict_fn
    cfg = _two_stage_cfg('faster_rcnn_r50_fpn')
    canvas = (256, 384)
    wrappers = (dk.deform_conv_fused, sk.stem_pool, sk.frozen_bottleneck,
                dk.deform_sample_cols, dk.deform_sample_split,
                dk.deform_sample_bwd, rb.fused_bottleneck, nms.greedy_nms)
    model = build_model(cfg).init_weights(0).eval()
    batch = {'image': torch.randint(0, 256, (2, *canvas, 3),
                                    generator=gen).to(torch.uint8),
             'img_hw': torch.tensor([[256.0, 380.0], [240.0, 384.0]]),
             'scale_factor': torch.tensor([1.0, 0.5])}
    before = [w.launches for w in wrappers]
    dets = make_predict_fn(model, cfg, canvas)(batch)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [0, 1, 3, 5, 0, 0, 0, 2]
    assert torch.isfinite(dets['det_bboxes']).all() and dets['valid'].any()
    del model
    model, _, step = init_trainer(cfg, canvas, 100)
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 200, (2, 8, 2))
    train = {'image': batch['image'].numpy(),
             'valid_hw': np.asarray([[256, 380], [240, 384]], np.int32),
             'gt_bboxes': np.concatenate(
                 [xy, xy + rng.uniform(24, 160, (2, 8, 2))], -1)
             .astype(np.float32),
             'gt_labels': rng.randint(1, 14, (2, 8)).astype(np.int32),
             'gt_kpts': np.zeros((2, 8, cfg.head.num_keypts, 3), np.float32),
             'gt_mask': np.ones((2, 8), bool)}
    before = [w.launches for w in wrappers]
    logs = step(train)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [0, 1, 3, 5, 0, 5, 0, 1]
    assert all(torch.isfinite(v) for v in logs.values())


@pytest.mark.parametrize('H,W,C,out,R', [
    (200, 336, 256, 14, 512),   # Mask R-CNN's mask RoIs on P2, 784 samples
    (200, 336, 32, 28, 512),    # the mask targets' map: 32 masks as channels
])
def test_roi_align_on_k6_k3_at_the_mask_shapes(gen, H, W, C, out, R):
    """ops/roi.py::roi_align on the card at chip_smoke.py's phase 1 mask
    shapes, batch 2, scale 1/4: one K6 launch forward and one K3 backward,
    f32 within TOL of the plain versions and the map's gradient within
    1e-4 of its largest value; bf16 within twice the plain version's error
    (or 1e-4 of the largest gradient)."""
    from kgdet_tpu_torch.ops.roi import roi_align
    b, stride = 2, 4
    xy = torch.rand((b, R, 2), generator=gen) \
        * torch.tensor([W * stride - 64.0, H * stride - 64.0])
    wh = 16.0 + torch.rand((b, R, 2), generator=gen) * 300
    boxes = torch.cat([xy, xy + wh], -1).cuda()
    feat = _randn(gen, b, H, W, C)
    cot = _randn(gen, b, R, out, out, C)

    def run(dtype, plain):
        f = feat.to(dtype).requires_grad_(True)
        with plain_kernels(plain):
            y = roi_align(f, boxes, out, 1.0 / stride, 2)
        g, = torch.autograd.grad((y.float() * cot).sum(), f)
        return y.detach().float(), g.float()
    k6, k3 = dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches
    got = run(torch.float32, False)
    assert (dk.deform_sample_cols.launches, dk.deform_sample_bwd.launches) \
        == (k6 + 1, k3 + 1)
    want = run(torch.float32, True)
    torch.testing.assert_close(got[0], want[0], **TOL)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5,
                               atol=1e-4 * want[1].abs().max().item())
    for k, p, w in zip(run(torch.bfloat16, False), run(torch.bfloat16, True),
                       want):
        assert (k - w).abs().max() <= max(2 * (p - w).abs().max().item(),
                                          1e-4 * w.abs().max().item())


def test_mask_targets_on_k6_match_the_plain_gather(gen):
    """models/mask_head.py::mask_targets on the card: the 32 ground-truth
    masks of an image as the channels of one map, one K6 launch, equal to
    the plain gather within TOL."""
    from kgdet_tpu_torch.models.mask_head import mask_targets
    masks = (torch.rand((2, 32, 200, 336), generator=gen) > 0.5).float() \
        .cuda()
    assigned = torch.randint(0, 32, (2, 512), generator=gen).cuda()
    xy = torch.rand((2, 512, 2), generator=gen) * 1200
    boxes = torch.cat([xy, xy + 16 + torch.rand((2, 512, 2),
                                                generator=gen) * 400],
                      -1).cuda()
    k6 = dk.deform_sample_cols.launches
    got = mask_targets(masks, assigned, boxes, 4)
    assert dk.deform_sample_cols.launches == k6 + 1
    with plain_kernels():
        want = mask_targets(masks, assigned, boxes, 4)
    assert got.shape == (2, 512, 28, 28)
    torch.testing.assert_close(got, want, **TOL)


def test_mask_rcnn_served_batch_launch_counts(gen):
    """configs/mask_rcnn_r50_fpn_1x_deepfashion2.py (f32) on the card at
    256x384, batch 2: a served batch launches K4 1, K5 3, K6 10 (5 levels
    for the boxes, 5 for the masks), K9 2 and nothing else, with finite
    detections and mask probabilities in [0, 1]."""
    from kgdet_tpu_torch.api import build_model, make_predict_fn
    cfg = _two_stage_cfg('mask_rcnn_r50_fpn')
    canvas = (256, 384)
    wrappers = (dk.deform_conv_fused, sk.stem_pool, sk.frozen_bottleneck,
                dk.deform_sample_cols, dk.deform_sample_split,
                dk.deform_sample_bwd, rb.fused_bottleneck, nms.greedy_nms)
    model = build_model(cfg).init_weights(0).eval()
    batch = {'image': torch.randint(0, 256, (2, *canvas, 3),
                                    generator=gen).to(torch.uint8),
             'img_hw': torch.tensor([[256.0, 380.0], [240.0, 384.0]]),
             'scale_factor': torch.tensor([1.0, 0.5])}
    before = [w.launches for w in wrappers]
    dets = make_predict_fn(model, cfg, canvas)(batch)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [0, 1, 3, 10, 0, 0, 0, 2]
    assert torch.isfinite(dets['det_bboxes']).all() and dets['valid'].any()
    masks = dets['det_masks']
    assert masks.shape == (2, 100, 28, 28)
    assert masks.min() >= 0 and masks.max() <= 1


def test_calibrated_prefix_on_k4_k5_matches_the_plain_prefix(gen, tmp_path):
    """calibrate_frozen_bn on the card (CONFIG_TEXT's R-50, two batches of 2
    at 64x96): every FrozenBatchNorm set; the prefix then refolds, and on
    K4 / K5 it matches the plain prefix on the same weights (f32 within
    TOL of the output's scale, bf16 within 2x the plain bf16 error). The
    plain prefix inside plain_kernels(), on the kept prepared weights,
    equals stem_layer1_ref on the folded f32 ones bit for bit."""
    from kgdet_tpu_torch.api import build_model
    from kgdet_tpu_torch.models.layers import FrozenBatchNorm
    from kgdet_tpu_torch.ops.image import device_normalize
    from kgdet_tpu_torch.utils.bn_calibration import calibrate_frozen_bn
    cfg = _tiny_cfg(tmp_path)
    model = build_model(cfg).init_weights(0).eval()
    bb = model.backbone
    images = [torch.randint(0, 256, (2, 64, 96, 3), generator=gen)
              .to(torch.uint8) for _ in range(2)]
    x = device_normalize(images[0].cuda())
    bb.frozen_prefix(x)
    kept = bb._kept[0]
    n = calibrate_frozen_bn(model, images)
    assert n == sum(isinstance(m, FrozenBatchNorm) for m in model.modules())
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for plain in (False, True):
            before = (sk.stem_pool.launches, sk.frozen_bottleneck.launches)
            with plain_kernels(plain):
                outs[dtype, plain] = bb.frozen_prefix(x.to(dtype))
            after = (sk.stem_pool.launches, sk.frozen_bottleneck.launches)
            assert after == (before if plain else
                             (before[0] + 1, before[1] + 3))
        (sw, sb), folded = bb.prefix_weights(dtype)[0]
        assert torch.equal(outs[dtype, True],
                           sk.stem_layer1_ref(x.to(dtype), sw, sb, folded))
    assert bb._kept[0] != kept
    ref = outs[torch.float32, True]
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(outs[torch.float32, False], ref,
                               rtol=TOL['rtol'], atol=TOL['atol'] * scale)
    assert (outs[torch.bfloat16, False].float() - ref).abs().max() <= \
        2 * (outs[torch.bfloat16, True].float() - ref).abs().max()


def test_get_flops_counts_the_same_on_both_devices(gen, tmp_path):
    """tools/get_flops.py on CONFIG_TEXT's R-50 at 64x96: the parameter
    count, the library FLOPs and each kernel's calls, FLOPs and bytes the
    same on the card (the kernels) as on the CPU (their plain versions)."""
    from kgdet_tpu_torch.tools import get_flops
    _tiny_cfg(tmp_path)
    path = str(tmp_path / 'cfg.py')
    cpu = get_flops.main([path, '--shape', '64', '96', '--device', 'cpu'])
    gpu = get_flops.main([path, '--shape', '64', '96'])
    assert gpu == cpu
    assert sorted(gpu['kernels']) == ['K1 deform_conv_fused',
                                      'K10 bn_epilogue', 'K4 stem_pool',
                                      'K5 frozen_bottleneck']


# ------------------------------------------------------- K9: greedy NMS
def _ulp_rows(thr):
    """Rows of two boxes, a pick and a candidate whose f32 IoU with it
    (pairwise_iou's arithmetic) is f32(thr), one ulp below or one above:
    the pick scores 0.9, the candidate 0.8. Returns (boxes (R, 2, 4),
    scores (R, 2), ious (R,))."""
    import numpy as np
    t = np.float32(thr)
    targets = [np.nextafter(t, np.float32(-1)), t, np.nextafter(t, np.float32(2))]
    rows = {float(v): [] for v in targets}
    for w in range(60, 400, 7):
        for h in (31.0, 47.0, 77.0, 120.0):
            d0 = np.float32(w - 2 * w * thr / (1 + thr))
            d = torch.from_numpy((d0 + np.arange(-400, 401, dtype=np.float32)
                                  * np.spacing(d0)).astype(np.float32))
            cand = torch.stack([d, torch.zeros_like(d), d + (w - 1),
                                torch.full_like(d, h - 1)], -1)
            pick = torch.tensor([0.0, 0.0, w - 1, h - 1])
            iou = nms.pairwise_iou(pick, cand)
            for v in targets:
                hit = (iou == float(v)).nonzero()[:, 0]
                if len(hit) and len(rows[float(v)]) < 4:
                    rows[float(v)].append(torch.stack([pick, cand[hit[0]]]))
    assert all(len(r) == 4 for r in rows.values()), thr
    boxes = torch.stack([b for r in rows.values() for b in r])
    return (boxes, torch.tensor([0.9, 0.8]).expand(len(boxes), 2),
            nms.pairwise_iou(boxes[:, 0], boxes[:, 1:])[:, 0])


def _nms_case(gen, case):
    """(boxes, scores, iou_thr, max_out) as the callers pass them:
    multiclass layout (boxes (B, 1, N, 4), scores the (B, C, N) view of a
    (B, N, C) tensor) or the proposals' (B, N, 4) / (B, N)."""
    shapes = {'served': (8, 13, 1000, 100, 0.5), 'batch1': (1, 13, 1000, 100, 0.5),
              'rpn': (2, 0, 4800, 1000, 0.7), 'global': (1, 2, 16384, 100, 0.5),
              'ragged': (3, 5, 777, 60, 0.5), 'small': (2, 3, 37, 20, 0.6),
              'ties': (2, 4, 1000, 100, 0.5), 'all_neg_inf': (2, 13, 1000, 100, 0.5),
              'exhausted': (4, 13, 1000, 100, 0.5),
              'max_out_over_n': (2, 3, 50, 100, 0.3),
              'nan': (2, 13, 1000, 100, 0.5)}
    B, C, N, max_out, thr = shapes[case]
    boxes = nms_boxes(gen, B, N)
    scores = torch.rand((B, N, max(C, 1)), generator=gen)
    if case == 'ties':                  # five levels: ties in every row
        scores = (scores * 4).round() / 4
        boxes = (boxes / 64).round() * 64     # and many identical boxes
    if case == 'all_neg_inf':
        scores[0] = nms.NEG_INF
        scores[1, :, 3] = nms.NEG_INF
    if case == 'exhausted':             # 0 to 40 candidates a row
        keep = torch.rand((B, N, C), generator=gen) < 0.02
        scores = torch.where(keep, scores, nms.NEG_INF)
        scores[0, :, 0] = nms.NEG_INF
    if case == 'nan':                   # NaN scores in two rows; NaN box
        scores[0, 17, 2] = scores[1, 900, 5] = float('nan')  # coordinates
        boxes[0, 3:40:3, 1] = boxes[1, 500, 2] = float('nan')
    boxes, scores = boxes.cuda(), scores.cuda()
    if C == 0:
        return boxes, scores[..., 0].contiguous(), thr, max_out
    return boxes[:, None], scores.transpose(1, 2), thr, max_out


def _k9_against_the_loop(boxes, scores, thr, max_out):
    before = nms.greedy_nms.launches
    idx, sc = nms.greedy_nms(boxes, scores, thr, max_out)
    assert nms.greedy_nms.launches == before + 1
    with plain_kernels():
        ref_idx, ref_sc = nms.greedy_nms(boxes, scores, thr, max_out)
    assert nms.greedy_nms.launches == before + 1
    assert idx.dtype == ref_idx.dtype == torch.int64
    assert sc.dtype == ref_sc.dtype == torch.float32
    assert torch.equal(idx, ref_idx)
    assert torch.equal(sc, ref_sc)
    return idx, sc


@pytest.mark.parametrize('case', [
    'served', 'batch1', 'rpn', 'global', 'ragged', 'small', 'ties',
    'all_neg_inf', 'exhausted', 'max_out_over_n', 'nan', 'ulp'])
def test_k9_equals_the_loop(gen, case):
    """K9 (ops/nms.py::greedy_nms on CUDA tensors) against its plain
    version, the loop, on the card, bit for bit in kept indices and
    scores: the cascade's served shapes (8 x 13 rows of 1,000, 100 steps)
    and batch 1; the RPN's (2 rows of 4,800, 1,000 steps, thr 0.7); 16,384
    candidates, over the shared memory a block can stage (the global
    copy); candidate counts off the block; tied scores and boxes; rows all
    NEG_INF; rows exhausted before max_out; max_out over N; NaN scores
    (torch.argmax ranks NaN first, and a NaN best ends its row) and NaN box
    coordinates (a NaN IoU suppresses nothing); and pairs whose f32 IoU is
    the threshold in f32 or one ulp around it, at 0.5, 0.7 and 0.4
    (f32(0.4) is above 0.4: the comparison is in f32)."""
    if case != 'ulp':
        boxes, scores, thr, max_out = _nms_case(gen, case)
        idx, sc = _k9_against_the_loop(boxes, scores, thr, max_out)
        empty = idx < 0
        assert torch.equal(empty, sc == nms.NEG_INF)
        if case in ('all_neg_inf', 'exhausted', 'max_out_over_n'):
            assert empty.any() and (~empty).any()
            # once a row runs out, every later slot is empty
            assert torch.equal(empty, empty.cummax(-1).values)
        if case == 'nan':               # only the rows with a NaN score
            assert empty[0, 2].all() and empty[1, 5].all()
            assert (~empty[..., 0]).sum() == empty[..., 0].numel() - 2
        return
    for thr in (0.5, 0.7, 0.4):
        boxes, scores, ious = _ulp_rows(thr)
        idx, _ = _k9_against_the_loop(boxes.cuda(), scores.cuda(), thr, 2)
        kept = idx[:, 1].cpu() == 1
        assert torch.equal(kept, ious <= torch.tensor(thr).float())
        assert kept.any() and (~kept).any()


def test_k9_is_one_kernel_a_call(gen):
    """One greedy_nms call on CUDA tensors puts one kernel on the device
    and nothing else: the staged body at the served shapes, the body on
    the global copy at 16,384 candidates. Counted by tools/profile.py's
    device_profile (ten calls between spin kernels; a recording whose
    counts are not a multiple of the calls, having lost device records at
    its edges, is taken again)."""
    for case, body in (('served', 'greedy_nms_kernel<true>'),
                       ('global', 'greedy_nms_kernel<false>')):
        boxes, scores, thr, max_out = _nms_case(gen, case)
        names = {}
        _, activities, own = device_profile(
            lambda: nms.greedy_nms(boxes, scores, thr, max_out), names=names)
        assert (activities, own) == (1, 1), names
        assert names['own'] == [body]


def test_cascade_served_decode_launch_counts(gen):
    """The cascade config as it ships, served on the card at 800x1344,
    batch 8, test.score_thr 0 (as kgbench's serve_b8): the decode (head
    outputs to padded detections) calls K9 once and puts fewer than 150
    activities on the device (the loop put 3,967); detections equal to
    the same decode on the loop (inside plain_kernels())."""
    import dataclasses
    import os

    from kgdet_tpu_torch.api import build_model
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.models.families import get_head_family
    from kgdet_tpu_torch.ops import image
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(
        root, 'configs', 'kgdet_moment_r50_fpn_1x_deepfashion2.py'))
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, score_thr=0.0))
    canvas = (800, 1344)
    model = build_model(cfg).init_weights(0).eval()
    img = torch.randint(0, 256, (8, *canvas, 3), generator=gen).to(
        torch.uint8).cuda()
    img_hw = torch.tensor([[800.0, 1344.0]] * 4 + [[752.0, 1000.0]] * 4,
                          device='cuda')
    sf = torch.tensor([1.0] * 4 + [0.78] * 4, device='cuda')
    decode = get_head_family(cfg.head.type).make_decode(cfg, canvas)
    with torch.inference_mode():
        outs = model(image.device_normalize(img, img_hw))
        before = nms.greedy_nms.launches
        dets = decode(outs, img_hw, sf)
        assert nms.greedy_nms.launches == before + 1
        names = _device_kernels(lambda: decode(outs, img_hw, sf))
        assert sum('greedy_nms' in n for n in names) == 1
        assert len(names) < 150, len(names)
        before = nms.greedy_nms.launches
        with plain_kernels():
            plain = decode(outs, img_hw, sf)
        assert nms.greedy_nms.launches == before
    for key in ('det_bboxes', 'det_labels', 'det_kpts', 'valid'):
        assert torch.equal(dets[key], plain[key])
    assert dets['valid'].all()


# ------------------------------------- the served backbone's BNs folded
def test_served_backbone_folds_its_frozen_bns(gen):
    """R-50 with its frozen prefix, bf16, batch 2 on an 800x1344 canvas,
    served (inference_mode): the 42 convs of layers 2 to 4 run with their
    FrozenBatchNorms folded in (models/layers.py::conv_frozen_bn). Stage
    outputs within the unfolded path's (the same module with grad enabled)
    bf16 distance from an f32 run; at least 250 fewer device activities
    than the unfolded path; no PyTorch elementwise pass over an
    activation: the only elementwise kernels are the 42 weight scales, and
    the shifts, ReLUs and residual sums are 39 K10 launches; and no copy
    kernel, neither a cast nor a 3x3 weight's copy into the activations'
    channels_last layout."""
    from kgdet_tpu_torch.models.layers import FrozenBatchNorm, conv_frozen_bn
    from kgdet_tpu_torch.models.resnet import ResNet
    net = ResNet(depth=50, frozen_stages=1)
    net.init_weights(gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    net = net.cuda()
    x = _randn(gen, 2, 800, 1344, 3)

    def unfolded(inp):
        with torch.enable_grad():
            return [o.detach() for o in net(inp)]

    def served(inp):
        with torch.inference_mode():
            return net(inp)
    ref = unfolded(x)
    xb = x.bfloat16()
    before = conv_frozen_bn.folded
    got = served(xb)
    assert conv_frozen_bn.folded == before + 42
    for g, p, r in zip(got, unfolded(xb), ref):
        assert g.dtype == torch.bfloat16
        assert (g.float() - r).abs().max() <= \
            2 * (p.float() - r).abs().max()
    folded = _device_kernels(lambda: served(xb))
    plain = _device_kernels(lambda: unfolded(xb))
    assert len(plain) - len(folded) >= 250, (len(plain), len(folded))
    elementwise = [n for n in folded if 'elementwise' in n]
    assert len(elementwise) == 42 and all('float' in n
                                          for n in elementwise), elementwise
    assert sum('bn_epilogue' in n for n in folded) == 39, folded
    assert not any('direct_copy' in n for n in folded), folded


# ------------------------------- K10: the epilogue of the served folded convs
def _bits(t):
    """A tensor's bits, so that NaN payloads and signed zeros compare."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _special(t):
    """t (channels-last) with NaN, +-inf and +-0 lanes spread through its
    memory."""
    flat = t.permute(0, 2, 3, 1).view(-1)
    for start, every, value in ((0, 7, float('nan')), (1, 11, float('inf')),
                                (2, 13, -float('inf')), (3, 5, -0.0),
                                (4, 9, 0.0)):
        flat[start::every] = value
    return t


def _k10_inputs(gen, N, C, H, W, dtype, mode):
    def a_map():
        return _special(_randn(gen, N, C, H, W).to(
            dtype, memory_format=torch.channels_last))
    shift = _randn(gen, C)
    shift[::6] = -0.0
    shift[1::6] = 0.0
    identity = a_map() if mode.startswith('identity') else None
    id_shift = _randn(gen, C) if mode == 'identity_shift' else None
    return a_map(), shift, identity, id_shift


@pytest.mark.parametrize('mode,relu', [('shift', False), ('shift', True),
                                       ('identity', True),
                                       ('identity_shift', True),
                                       ('identity_shift', False)])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('N,C,H,W', [
    (2, 8, 5, 7), (2, 24, 9, 13), (1, 2048, 3, 4),
    (2, 12, 6, 5),          # C % 8 != 0: bf16 takes the scalar body
    (2, 13, 4, 3),          # odd C: both dtypes scalar
    (3, 64, 1, 1),          # 1x1 maps
    (4, 512, 100, 168)])    # many waves of blocks
def test_k10_equals_its_plain_version(gen, N, C, H, W, dtype, mode, relu):
    """K10 against bn_epilogue_ref (the PyTorch chain) on the card, bit for
    bit with NaN, +-inf and +-0 lanes: in place in y, returning y, leaving
    the identity and the shifts as they were; one launch."""
    from kgdet_tpu_torch.ops import bn_epilogue as be
    y, shift, identity, id_shift = _k10_inputs(gen, N, C, H, W, dtype, mode)
    inputs = [t for t in (shift, identity, id_shift) if t is not None]
    kept = [t.clone() for t in inputs]
    want = be.bn_epilogue_ref(y.clone(), shift, identity, id_shift, relu)
    ptr, launches = y.data_ptr(), be.bn_epilogue.launches
    got = be.bn_epilogue(y, shift, identity, id_shift, relu)
    torch.cuda.synchronize()
    assert be.bn_epilogue.launches == launches + 1
    assert got is y and y.data_ptr() == ptr
    assert torch.equal(_bits(got.contiguous()), _bits(want.contiguous()))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(kept, inputs))


def test_k10_refuses_what_it_does_not_take(gen):
    """float16, contiguous NCHW, a strided view, an identity in another
    layout or overlapping the map, a shape or shift that does not match,
    more channels than the shared memory holds, 2**31 elements: ValueError
    or TypeError, no launch."""
    from kgdet_tpu_torch.ops import bn_epilogue as be
    y = _randn(gen, 2, 16, 6, 8).to(memory_format=torch.channels_last)
    shift = _randn(gen, 16)
    wide = _randn(gen, 1, be.MAX_CHANNELS + 8, 1, 2)
    cases = [
        (TypeError, (y.half(), shift)),
        (ValueError, (y.contiguous(), shift)),
        (ValueError, (y[:, :, :, ::2], shift)),
        (ValueError, (y, shift, y.contiguous())),
        (ValueError, (y, shift, y)),
        (ValueError, (y, shift, y[:1].clone())),
        (ValueError, (y, shift.bfloat16())),
        (ValueError, (y, shift[:8])),
        (ValueError, (y, shift, None, shift)),
        (ValueError, (wide, _randn(gen, be.MAX_CHANNELS + 8))),
        # 2**31 elements: past the kernel's 32-bit indices (4 GiB)
        (ValueError, (torch.empty((1, 8, 2 ** 14, 2 ** 14),
                                  dtype=torch.bfloat16, device='cuda',
                                  memory_format=torch.channels_last),
                      _randn(gen, 8))),
    ]
    launches = be.bn_epilogue.launches
    for error, args in cases:
        with pytest.raises(error):
            be.bn_epilogue(*args)
    assert be.bn_epilogue.launches == launches


def test_served_r50_batch_of_8_on_k10_equals_the_plain_epilogue(
        gen, monkeypatch):
    """R-50 with its frozen prefix, bf16, served at batch 8 on an 800x1344
    canvas (the serve_b8 cells' trunk): every stage output equals, to the
    bit, the same forward with the epilogue wrapper alone swapped for its
    plain version; 39 K10 launches a forward, each on a channels-last map,
    and kernel_cost's K10 tally the 4,627,761,152 bytes counted from the
    shapes."""
    from kgdet_tpu_torch.models import layers
    from kgdet_tpu_torch.models.resnet import ResNet
    from kgdet_tpu_torch.ops import bn_epilogue as be
    from kgdet_tpu_torch.ops import kernel_cost
    net = ResNet(depth=50, frozen_stages=1)
    net.init_weights(gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, layers.FrozenBatchNorm):
                c = m.weight.shape
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    net = net.cuda()
    x = _randn(gen, 8, 800, 1344, 3).bfloat16()
    maps = []
    real = be.bn_epilogue

    def kernel(y, *args, **kwargs):
        maps.append(y.is_contiguous(memory_format=torch.channels_last))
        return real(y, *args, **kwargs)
    monkeypatch.setattr(layers, 'bn_epilogue', kernel)
    launches = be.bn_epilogue.launches
    with torch.inference_mode(), kernel_cost.tally() as t:
        got = net(x)
    assert be.bn_epilogue.launches == launches + 39
    assert maps == [True] * 39
    assert t.kernels['K10 bn_epilogue'] == {
        'calls': 39, 'flops': 0, 'bytes': 4_627_761_152}
    monkeypatch.setattr(layers, 'bn_epilogue', be.bn_epilogue_ref)
    with torch.inference_mode():
        want = net(x)
    assert be.bn_epilogue.launches == launches + 39
    for g, w in zip(got, want):
        assert torch.equal(_bits(g.contiguous()), _bits(w.contiguous()))


# path: (config file, fields of its backbone replaced, K10 launches a
# served forward). DCN in c3-c5: conv2 of those 13 blocks keeps its BN and
# ReLU; the context block in c3-c5: conv3 and the 3 downsamples take the
# shift alone, 13 x 3 + 3; ResNeXt-101 and HRNet run every block through
# the fold (no frozen prefix); C4: layers 2 and 3 in the backbone, res5
# over the RoI features in the shared head
K10_FAMILIES = {
    'dcn': ('kgdet_moment_r50_fpn_1x', dict(dcn_stages=(1, 2, 3)), 26),
    'gcb': ('kgdet_moment_r50_fpn_1x', dict(gcb_stages=(1, 2, 3)), 42),
    'x101': ('faster_rcnn_x101_32x4d_fpn_1x', {}, 99),
    'hrnet': ('faster_rcnn_hrnetv2p_w32_1x', {}, 220),
    'c4': ('faster_rcnn_r50_caffe_c4_1x', {}, 39),
}


@pytest.mark.parametrize('path', list(K10_FAMILIES))
def test_served_block_families_run_k10_as_their_plain_epilogue(
        gen, monkeypatch, path):
    """One served bf16 batch of 2 at 256x384 through make_predict_fn on the
    card, for each block family the served models hold beside the plain
    R-50: every K10 call takes the map in the layout the model gives it
    (channels-last; the wrapper raises on any other), gives bit for bit
    what its plain version gives on a copy of the same inputs, and the
    forward launches K10 the path's number of times."""
    import dataclasses
    import os

    from kgdet_tpu_torch.api import build_model, load_config, \
        make_predict_fn
    from kgdet_tpu_torch.models import layers
    from kgdet_tpu_torch.ops import bn_epilogue as be
    file, backbone, want = K10_FAMILIES[path]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, 'configs',
                                   f'{file}_deepfashion2.py'))
    cfg = cfg.replace(compute_dtype='bfloat16',
                      backbone=dataclasses.replace(cfg.backbone, **backbone),
                      test=dataclasses.replace(cfg.test, score_thr=0.0))
    canvas = (256, 384)
    batch = {'image': torch.randint(0, 256, (2, *canvas, 3),
                                    generator=gen).to(torch.uint8),
             'img_hw': torch.tensor([[256.0, 380.0], [240.0, 384.0]]),
             'scale_factor': torch.tensor([1.0, 0.5])}
    real, calls = be.bn_epilogue, []

    def checked(y, shift, identity=None, identity_shift=None, relu=True):
        plain = be.bn_epilogue_ref(y.clone(), shift, identity,
                                   identity_shift, relu)
        got = real(y, shift, identity, identity_shift, relu)
        calls.append(torch.equal(_bits(got.contiguous()),
                                 _bits(plain.contiguous())))
        return got
    model = build_model(cfg).init_weights(0).eval()
    monkeypatch.setattr(layers, 'bn_epilogue', checked)
    launches = be.bn_epilogue.launches
    make_predict_fn(model, cfg, canvas)(batch)
    assert be.bn_epilogue.launches - launches == want
    assert calls == [True] * want
