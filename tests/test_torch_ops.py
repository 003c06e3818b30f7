"""Port ops (kgdet_tpu_torch.ops) against their kgdet_tpu counterparts.

Same inputs, made with numpy from a seed, go through the JAX function and
the port's; f32 throughout, tolerance 1e-4 (tests/test_reference_parity.py)
unless stated.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kgdet_tpu.ops import deform as jdeform
from kgdet_tpu.ops import image as jimage
from kgdet_tpu.ops import nms as jnms
from kgdet_tpu.ops import points as jpoints
from kgdet_tpu.config import HeadConfig
from kgdet_tpu.core import iou_assign as jiou
from kgdet_tpu.core import loss as jloss
from kgdet_tpu.core import targets as jtargets
from kgdet_tpu.ops import losses as jlosses
from kgdet_tpu.ops.pallas_deform import _prep_indices as j_prep_indices
from kgdet_tpu.ops.pallas_deform import _prep_indices_bwd_vw
from kgdet_tpu_torch.core import iou_assign as tiou
from kgdet_tpu_torch.core import loss as tloss
from kgdet_tpu_torch.core import targets as ttargets
from kgdet_tpu_torch.ops import deform, image, losses, nms, points
from kgdet_tpu_torch.ops import deform_kernels as dk
from kgdet_tpu_torch.ops import stem_kernels as sk

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_bilinear_gather_matches_jax():
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 6, 7, 16).astype(np.float32)
    # positions well outside the map on every side, plus exact integers
    pos = rng.uniform(-3, 10, (2, 11, 5, 2)).astype(np.float32)
    pos[0, 0, 0] = (5.0, 6.0)
    pos[0, 0, 1] = (0.0, 0.0)
    want = jdeform.bilinear_gather(jnp.asarray(feat), jnp.asarray(pos))
    got = deform.bilinear_gather(_t(feat), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prep_indices_matches_pallas_prep():
    """The shared index/weight prep (the kernel's input) equals the TPU
    kernel's _prep_indices, boundary cases included."""
    rng = np.random.RandomState(1)
    pos = rng.uniform(-2.5, 8.5, (2, 9, 4, 2)).astype(np.float32)
    pos[1, 0, 0] = (-1.0, 6.0)
    want_s, want_w = j_prep_indices(jnp.asarray(pos), 6, 7)
    got_s, got_w = deform.prep_indices(_t(pos), 6, 7)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-7)


@pytest.mark.parametrize('H,W', [(1, 5), (4, 1), (1, 1)])
def test_bilinear_gather_small_maps_match_zero_padded(H, W):
    """H<2 / W<2 maps sample as if zero-padded to 2 (CUDA boundary
    semantics): the JAX sampler pads the same way in deform_sample."""
    rng = np.random.RandomState(2)
    feat = rng.randn(1, H, W, 8).astype(np.float32)
    pos = rng.uniform(-1.5, 2.5, (1, 6, 3, 2)).astype(np.float32)
    padded = np.pad(feat, ((0, 0), (0, max(2 - H, 0)), (0, max(2 - W, 0)),
                           (0, 0)))
    want = jdeform.bilinear_gather(jnp.asarray(padded), jnp.asarray(pos))
    got = deform.bilinear_gather(_t(feat), _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_absolute_positions_and_grad_multiply_match_jax():
    rng = np.random.RandomState(3)
    rel = rng.randn(2, 3, 4, 5, 2).astype(np.float32)
    want = jdeform.absolute_positions(jnp.asarray(rel), 3, 4)
    got = deform.absolute_positions(_t(rel), 3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = rng.randn(7).astype(np.float32)
    np.testing.assert_allclose(
        deform.grad_multiply(_t(x), 0.1).numpy(),
        np.asarray(jdeform.grad_multiply(jnp.asarray(x), 0.1)), atol=1e-7)


def test_grad_multiply_scales_only_the_gradient():
    x = torch.tensor([1.5, -2.0], requires_grad=True)
    y = deform.grad_multiply(x, 0.1)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), [1.5, -2.0], atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), [0.1, 0.1], atol=1e-7)


@pytest.mark.parametrize('method', ['moment', 'minmax', 'partial_minmax'])
def test_points2bbox_matches_jax(method):
    rng = np.random.RandomState(4)
    pts = (rng.randn(2, 5, 2 * 9) * 3).astype(np.float32)
    pts[0, 0] = 1.25          # a collapsed point set: std -> sqrt(1e-6)
    mt = np.asarray([0.3, -0.2], np.float32)
    want = jpoints.points2bbox(jnp.asarray(pts), method, jnp.asarray(mt))
    got = points.points2bbox(_t(pts), method, _t(mt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_grid_and_offsets_match_jax():
    np.testing.assert_array_equal(points.grid_points(3, 4, 8).numpy(),
                                  np.asarray(jpoints.grid_points(3, 4, 8)))
    rng = np.random.RandomState(5)
    off = rng.randn(2, 12, 6).astype(np.float32)
    ctr = rng.rand(12, 2).astype(np.float32) * 50
    want = jpoints.offsets_to_coords(jnp.asarray(off), jnp.asarray(ctr), 16)
    got = points.offsets_to_coords(_t(off), _t(ctr), 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_device_normalize_matches_jax():
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (2, 8, 12, 3)).astype(np.uint8)
    ext = np.asarray([[8, 12], [5, 7]], np.int32)
    want = jimage.device_normalize(jnp.asarray(img), jnp.asarray(ext))
    got = image.device_normalize(_t(img), _t(ext))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = torch.randn(1, 4, 4, 3)
    assert image.device_normalize(x) is x


def _nms_case(seed, n=30, c=4):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 60, (n, 2))
    wh = rng.uniform(5, 30, (n, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(n, c).astype(np.float32)
    kpts = rng.randn(n, 9).astype(np.float32)
    return boxes, scores, kpts


def _check_nms(boxes, scores, kpts, **kw):
    want = jnms.multiclass_nms_kp(jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(kpts), **kw)
    got = nms.multiclass_nms_kp(_t(boxes), _t(scores), _t(kpts), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize('nms_type', ['nms', 'soft_nms'])
def test_multiclass_nms_kp_matches_jax(nms_type):
    boxes, scores, kpts = _nms_case(7)
    _check_nms(boxes, scores, kpts, score_thr=0.2, iou_thr=0.4,
               max_per_class=6, max_per_img=12, nms_type=nms_type)


def test_multiclass_nms_kp_tie_order_matches_jax():
    """Equal scores: argmax takes the first index and the final top-k keeps
    the lower flat index first, as jax.lax.top_k does."""
    boxes, scores, kpts = _nms_case(8, n=12, c=3)
    boxes[:] = np.asarray([10, 10, 20, 20]) + \
        np.arange(12)[:, None] * 40              # disjoint boxes
    scores[:] = 0.5                              # every score tied
    scores[3, 1] = 0.7
    _check_nms(boxes, scores, kpts, score_thr=0.1, iou_thr=0.5,
               max_per_class=5, max_per_img=8)


def test_multiclass_nms_kp_batched_equals_per_image():
    cases = [_nms_case(s) for s in (9, 10)]
    kw = dict(score_thr=0.3, iou_thr=0.5, max_per_class=5, max_per_img=9)
    got = nms.multiclass_nms_kp(*[torch.stack([_t(c[i]) for c in cases])
                                  for i in range(3)], **kw)
    for b, case in enumerate(cases):
        one = nms.multiclass_nms_kp(*[_t(a) for a in case], **kw)
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g[b].numpy(), o.numpy())


# the boundary positions of tests/test_pallas_deform.py
# (test_bwd_boundary_positions_match_xla), six pixels of two taps on a 5x5
# map: straddling and clamped at every border, fully outside, and exactly
# on integer coordinates
BOUNDARY_POS = np.array(
    [[[-0.5, 2.0], [4.5, 4.5]],
     [[-10., -10.], [2.2, -0.7]],
     [[0.0, 0.0], [4.0, 4.0]],
     [[3.9, 4.7], [-0.2, 0.1]],
     [[1.5, 6.0], [6.0, 1.5]],
     [[2.0, 2.0], [5.2, 5.2]]], np.float32)


def test_prep_indices_bwd_matches_pallas_prep():
    """The backward's coefficient prep equals the TPU path's
    _prep_indices_bwd_vw once its paired corner order (tl, bl, tr, br) is
    mapped to the port's (tl, tr, bl, br); integer and border positions
    included. Exact: both are the same f32 expressions."""
    rng = np.random.RandomState(12)
    pos = rng.uniform(-2.5, 7.5, (2, 6, 2, 2)).astype(np.float32)
    pos[0] = BOUNDARY_POS
    want_s, want_wd = _prep_indices_bwd_vw(jnp.asarray(pos), 5, 5)
    got_s, got_wd = deform.prep_indices_bwd(_t(pos), 5, 5)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    paired = np.asarray(want_wd).reshape(2, 6, 2, 3, 4)[..., [0, 2, 1, 3]]
    np.testing.assert_array_equal(got_wd.numpy().reshape(2, 6, 2, 3, 4),
                                  paired)
    # the derivative cases: coefficients of d/dy and d/dx at an integer
    # position are those of floor()'s cell, weights of -1/+1 times the lerp
    wd = got_wd[0, 5, 0].numpy()            # (2.0, 2.0): frac 0 on both axes
    np.testing.assert_array_equal(wd[:4], [1, 0, 0, 0])
    np.testing.assert_array_equal(wd[4:8], [-1, 0, 1, 0])
    np.testing.assert_array_equal(wd[8:], [-1, 1, 0, 0])
    np.testing.assert_array_equal(got_wd[0, 1, 0].numpy(), np.zeros(12))


def test_losses_match_jax():
    rng = np.random.RandomState(13)
    logits = (rng.randn(40, 13) * 3).astype(np.float32)
    labels = rng.randint(0, 14, 40).astype(np.int32)
    w = rng.rand(40).astype(np.float32)
    for kw in (dict(avg_factor=7.0), dict()):
        want = jlosses.sigmoid_focal_loss(jnp.asarray(logits),
                                          jnp.asarray(labels),
                                          jnp.asarray(w), **kw)
        got = losses.sigmoid_focal_loss(_t(logits), _t(labels), _t(w), **kw)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    pred = rng.randn(30, 8).astype(np.float32)
    tgt = pred + rng.randn(30, 8).astype(np.float32) * 0.2
    w2 = rng.rand(30, 8).astype(np.float32)
    for kw in (dict(beta=1 / 9, avg_factor=5.0), dict()):
        want = jlosses.smooth_l1_loss(jnp.asarray(pred), jnp.asarray(tgt),
                                      jnp.asarray(w2), **kw)
        got = losses.smooth_l1_loss(_t(pred), _t(tgt), _t(w2), **kw)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_valid_flags_match_jax():
    want = jpoints.valid_flags(4, 6, 3, 5)
    np.testing.assert_array_equal(points.valid_flags(4, 6, 3, 5).numpy(),
                                  np.asarray(want))
    got = points.valid_flags(4, 6, torch.tensor([3, 4]), torch.tensor([5, 2]))
    assert got.shape == (2, 24)
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(jpoints.valid_flags(4, 6, 4, 2)))


def _target_case(seed, K=5):
    """Two images over a two-level grid (strides 8 and 16 in one point
    list), boxes of mixed scale, one padded GT, an invalid margin, and
    duplicate boxes so that equidistant candidates and GT ties occur."""
    rng = np.random.RandomState(seed)
    grids = np.concatenate([np.asarray(jpoints.grid_points(8, 12, 8)),
                            np.asarray(jpoints.grid_points(4, 6, 16))])
    B, G = 2, 5
    ctr = rng.uniform(16, 70, (B, G, 2))
    wh = rng.uniform(6, 60, (B, G, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1) \
        .astype(np.float32)
    boxes[0, 1] = boxes[0, 0]                      # tie between two GTs
    boxes[1, 2] = (32, 32, 48, 48)                 # centered on a grid point
    labels = rng.randint(1, 14, (B, G)).astype(np.int32)
    kpts = rng.uniform(0, 90, (B, G, K, 3)).astype(np.float32)
    kpts[..., 2] = (rng.rand(B, G, K) > 0.4).astype(np.float32)
    kpts[0, 2, :, 2] = 0                           # an instance with none
    mask = np.ones((B, G), bool)
    mask[:, -1] = False
    valid = np.ones((B, len(grids)), bool)
    valid[1, grids[:, 0] >= 80] = False
    return grids, valid, boxes, labels, kpts, mask


@pytest.mark.parametrize('seed', [14, 15])
def test_point_targets_match_jax(seed):
    """All seven fields; exact for the integer ones, 1e-6 for the rest
    (they are copies of the inputs or 0/1 masks)."""
    grids, valid, boxes, labels, kpts, mask = _target_case(seed)
    want = jtargets.point_targets(
        jnp.asarray(grids), jnp.asarray(valid), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(kpts), jnp.asarray(mask),
        scale=4, pos_num=3)
    got = ttargets.point_targets(_t(grids), _t(valid), _t(boxes), _t(labels),
                                 _t(kpts), _t(mask), scale=4, pos_num=3)
    assert int(np.asarray(want.labels != 0).sum()) > 4
    for name in ttargets.PointTargets._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name in ('labels', 'num_pos'):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=name)


def test_assign_points_single_matches_jax():
    grids, valid, boxes, labels, kpts, mask = _target_case(16)
    want_a, want_p = jtargets.assign_points_single(
        jnp.asarray(grids), jnp.asarray(valid[1]), jnp.asarray(boxes[1]),
        jnp.asarray(mask[1]), 4, 25)
    got_a, got_p = ttargets.assign_points_single(
        _t(grids), _t(valid[1]), _t(boxes[1]), _t(mask[1]), 4, 25)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_a.numpy()[got_p.numpy()],
                                  np.asarray(want_a)[np.asarray(want_p)])


def test_kgdet_loss_terms_match_jax():
    """Each of the nine terms, num_pos and the total, f32, 1e-5 relative."""
    rng = np.random.RandomState(17)
    K = 5
    grids, valid, boxes, labels, kpts, mask = _target_case(17, K)
    grids = grids[:96]                              # one level, 8x12
    valid = valid[:, :96]
    head = HeadConfig(num_keypts=K)
    outs = {'cls': rng.randn(3, 2, 8, 12, 13).astype(np.float32) * 2,
            'kpt': rng.randn(3, 2, 8, 12, 2 * K).astype(np.float32) * 2,
            'bbox': rng.randn(3, 2, 8, 12, 4).astype(np.float32) * 2}
    jt = jtargets.point_targets(
        jnp.asarray(grids), jnp.asarray(valid), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(kpts), jnp.asarray(mask),
        scale=4, pos_num=4)
    tt = ttargets.point_targets(_t(grids), _t(valid), _t(boxes), _t(labels),
                                _t(kpts), _t(mask), scale=4, pos_num=4)
    want_total, want = jloss.kgdet_loss(
        [{k: jnp.asarray(v) for k, v in outs.items()}], [jnp.asarray(grids)],
        [jt], head)
    got_total, got = tloss.kgdet_loss(
        [{k: _t(v) for k, v in outs.items()}], [_t(grids)], [tt], head)
    assert sorted(got) == sorted(want) and len(got) == 10
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
        assert float(want[k]) > 0, k
    np.testing.assert_allclose(got_total.item(), float(want_total), rtol=1e-5)


def test_wrappers_run_plain_versions_on_cpu():
    """CPU tensors go to the plain versions and launch nothing."""
    rng = np.random.RandomState(11)
    feat = _t(rng.randn(1, 4, 5, 8).astype(np.float32))
    pos = _t(rng.uniform(-1, 5, (1, 6, 3, 2)).astype(np.float32))
    w = _t(rng.randn(3, 8, 4).astype(np.float32))
    before = (dk.deform_conv_fused.launches, sk.stem_pool.launches,
              sk.frozen_bottleneck.launches)
    np.testing.assert_array_equal(
        dk.deform_conv_fused(feat, pos, w).numpy(),
        dk.deform_conv_fused_ref(feat, pos, w).numpy())
    x = _t(rng.randn(1, 16, 12, 3).astype(np.float32))
    sw = _t(rng.randn(7, 7, 3, 64).astype(np.float32) * .1)
    sb = _t(rng.randn(64).astype(np.float32))
    np.testing.assert_array_equal(sk.stem_pool(x, sw, sb).numpy(),
                                  sk.stem_pool_ref(x, sw, sb).numpy())
    cols = dk.deform_sample_split(feat, feat * 2, pos, (1, 2))
    want = dk.deform_sample_split_ref(feat, feat * 2, pos, (1, 2))
    for pair, wpair in zip(cols, want):
        for c, wc in zip(pair, wpair):
            np.testing.assert_array_equal(c.numpy(), wc.numpy())
    g = _t(rng.randn(1, 6, 3, 8).astype(np.float32))
    for a, b in zip(dk.deform_sample_bwd(feat, pos, g),
                    dk.deform_sample_bwd_ref(feat, pos, g)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (dk.deform_conv_fused.launches, sk.stem_pool.launches,
            sk.frozen_bottleneck.launches) == before
    assert dk.deform_sample_split.launches == 0
    assert dk.deform_sample_bwd.launches == 0


# ------------------------------------------- relative-offset entries, K6 + K3
def _off_grid(rng, lo, hi, shape):
    """Uniform positions kept at least 0.05 off the integer grid, where
    bilinear sampling is differentiable."""
    v = rng.uniform(lo, hi, shape)
    return (np.floor(v) + 0.05 + 0.9 * (v - np.floor(v))).astype(np.float32)


@pytest.mark.parametrize('stride,H,W', [(1, 5, 6), (2, 5, 6), (2, 1, 7)])
def test_deform_sample_matches_jax(stride, H, W):
    """Output pixel centres at stride times the output index; a one-row map
    is zero-padded by both. 1e-4 (TOL)."""
    rng = np.random.RandomState(20 + stride + H)
    Ho, Wo = -(-H // stride), -(-W // stride)
    feat = rng.randn(2, H, W, 8).astype(np.float32)
    rel = rng.uniform(-3, 3, (2, Ho, Wo, 4, 2)).astype(np.float32)
    want = jdeform.deform_sample(jnp.asarray(feat), jnp.asarray(rel),
                                 stride=stride)
    got = deform.deform_sample(_t(feat), _t(rel), stride=stride)
    assert got.shape == (2, Ho * Wo, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('modulated', [False, True])
def test_deform_conv_matches_jax(modulated):
    """Sample + contract with a bias, v1 and modulated (v2), at stride 2:
    values and the gradients of the map, the offsets and the weight
    against jax.vjp. 1e-4 of each tensor's scale."""
    rng = np.random.RandomState(23)
    H, W, C, K, F, stride = 6, 7, 8, 9, 5, 2
    Ho, Wo = 3, 4
    feat = rng.randn(2, H, W, C).astype(np.float32)
    rel = _off_grid(rng, -2, 2, (2, Ho, Wo, K, 2))
    w = (rng.randn(K, C, F) * .2).astype(np.float32)
    bias = rng.randn(F).astype(np.float32)
    mod = rng.rand(2, Ho, Wo, K).astype(np.float32) if modulated else None
    ct = rng.randn(2, Ho, Wo, F).astype(np.float32)

    def jfn(f, r, w_):
        return jdeform.deform_conv(
            f, r, w_, jnp.asarray(bias),
            None if mod is None else jnp.asarray(mod), stride=stride)
    want, vjp = jax.vjp(jfn, jnp.asarray(feat), jnp.asarray(rel),
                        jnp.asarray(w))
    want_g = vjp(jnp.asarray(ct))
    leaves = [_t(a).requires_grad_() for a in (feat, rel, w)]
    got = deform.deform_conv(*leaves, _t(bias),
                             None if mod is None else _t(mod), stride=stride)
    got_g = torch.autograd.grad(got, leaves, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, wg in zip(got_g, want_g):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg,
                                   atol=1e-4 * np.abs(wg).max())


def _fused_case(seed):
    rng = np.random.RandomState(seed)
    B, H, W, C, K, F = 2, 5, 6, 8, 9, 7
    P = H * W
    feat = rng.randn(B, H, W, C).astype(np.float32)
    pos = _off_grid(rng, -1.5, 7, (B, P, K, 2))
    w = (rng.randn(K, C, F) * .3).astype(np.float32)
    return feat, pos, w, rng.randn(B, P, F).astype(np.float32), \
        rng.randn(B, P, K, C).astype(np.float32)


def test_fused_conv_function_matches_jax_vjp():
    """deform_conv_fused under differentiation (the Function over K6 and
    K3, plain versions on the CPU) against jax.vjp through the JAX
    package's CPU route (bilinear_gather + deform_conv_from_samples), at a
    channel count its TPU kernels do not take. Output and all three
    gradients, 1e-4 of each gradient's scale."""
    feat, pos, w, ct, _ = _fused_case(24)

    def jfn(f, p, w_):
        cols = jdeform.bilinear_gather(f, p)
        return jdeform.deform_conv_from_samples(cols, w_)
    want, vjp = jax.vjp(jfn, jnp.asarray(feat), jnp.asarray(pos),
                        jnp.asarray(w))
    want_g = vjp(jnp.asarray(ct))
    leaves = [_t(a).requires_grad_() for a in (feat, pos, w)]
    got = dk.deform_conv_fused(*leaves)
    assert 'FusedConvGrad' in type(got.grad_fn).__name__
    got_g = torch.autograd.grad(got, leaves, _t(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, wg in zip(got_g, want_g):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg,
                                   atol=1e-4 * np.abs(wg).max())
    # no gradient wanted: the fused inference entry, same values
    with torch.no_grad():
        fused = dk.deform_conv_fused(*leaves)
    assert fused.grad_fn is None
    np.testing.assert_allclose(fused.numpy(), got.detach().numpy(),
                               atol=1e-5)
    plain = dk.deform_conv_fused(*leaves, plain=True)
    np.testing.assert_array_equal(plain.detach().numpy(),
                                  got.detach().numpy())


def test_fused_conv_function_gradcheck():
    """torch.autograd.gradcheck of the Function in f64, positions off the
    integer grid."""
    rng = np.random.RandomState(27)
    feat = rng.randn(1, 3, 4, 3)
    pos = _off_grid(rng, -0.9, 3.9, (1, 5, 2, 2)).astype(np.float64)
    w = rng.randn(2, 3, 4) * .3
    inputs = [_t(a).requires_grad_() for a in (feat, pos, w)]
    assert torch.autograd.gradcheck(dk.deform_conv_fused, inputs, eps=1e-6,
                                    atol=1e-6)


# ------------------------------------------------------------- MaxIoU assign
def test_iou_and_iof_match_jax():
    rng = np.random.RandomState(28)
    xy = rng.uniform(0, 40, (2, 7, 2))
    a = np.concatenate([xy, xy + rng.uniform(0, 30, (2, 7, 2))], -1) \
        .astype(np.float32)
    xy = rng.uniform(0, 40, (2, 11, 2))
    b = np.concatenate([xy, xy + rng.uniform(0, 30, (2, 11, 2))], -1) \
        .astype(np.float32)
    a[0, 0] = (5, 5, 5, 9)                          # zero area
    b[0, 0] = a[0, 1]                               # IoU 1
    got = tiou.iou_xyxy(_t(a), _t(b))
    got_f = tiou.iof_xyxy(_t(a), _t(b))
    assert got.shape == (2, 7, 11)
    for i in range(2):                              # batched == per image
        np.testing.assert_allclose(
            got[i].numpy(), np.asarray(jiou.iou_xyxy(jnp.asarray(a[i]),
                                                     jnp.asarray(b[i]))),
            atol=1e-6)
        np.testing.assert_allclose(
            got_f[i].numpy(), np.asarray(jiou.iof_xyxy(jnp.asarray(a[i]),
                                                       jnp.asarray(b[i]))),
            atol=1e-6)
    one = tiou.iou_xyxy(_t(np.asarray([[0., 0., 10., 10.]], np.float32)),
                        _t(np.asarray([[0., 0., 10., 10.],
                                       [5., 5., 15., 15.],
                                       [20., 20., 30., 30.]], np.float32)))
    np.testing.assert_allclose(one[0].numpy(), [1.0, 25. / 175., 0.0],
                               atol=1e-6)


# the four semantic cases of tests/test_variants.py: thresholds, a GT that
# claims its best candidate below pos_thr, a padded GT, and (IoU matrix
# above) the matrix itself
ASSIGN_CASES = {
    'thresholds': dict(
        gts=[[0., 0., 10., 10.], [20., 0., 30., 10.]], gt_mask=[True, True],
        cands=[[0., 0., 10., 10.], [0., 0., 5., 10.], [0., 0., 4.5, 10.],
               [0., 0., 3., 10.], [21., 0., 30., 10.],
               [100., 100., 110., 110.]],
        pos=[True, True, False, False, True, False],
        ign=[False, False, True, False, False, False],
        assigned={0: 0, 1: 0, 4: 1}),
    'gt_claims_best': dict(
        gts=[[0., 0., 10., 10.]], gt_mask=[True],
        cands=[[0., 0., 4., 10.], [50., 50., 60., 60.]],
        pos=[True, False], ign=[False, False], assigned={0: 0}),
    'padded_gt': dict(
        gts=[[0., 0., 10., 10.], [0., 0., 10., 10.]], gt_mask=[True, False],
        cands=[[0., 0., 10., 10.]], pos=[True], ign=[False],
        assigned={0: 0}),
    'later_gt_overrides': dict(
        gts=[[0., 0., 10., 10.], [0., 0., 10., 10.]], gt_mask=[True, True],
        cands=[[0., 0., 10., 10.], [30., 30., 40., 40.]],
        pos=[True, False], ign=[False, False], assigned={0: 1}),
}


@pytest.mark.parametrize('case', sorted(ASSIGN_CASES))
def test_assign_max_iou_semantics_match_jax(case):
    c = ASSIGN_CASES[case]
    gts, cands = np.asarray(c['gts'], np.float32), \
        np.asarray(c['cands'], np.float32)
    mask = np.asarray(c['gt_mask'])
    valid = np.ones(len(cands), bool)
    want = jiou.assign_max_iou(jnp.asarray(cands), jnp.asarray(valid),
                               jnp.asarray(gts), jnp.asarray(mask),
                               pos_iou_thr=0.5, neg_iou_thr=0.4,
                               min_pos_iou=0.0)
    got = tiou.assign_max_iou(_t(cands), _t(valid), _t(gts), _t(mask),
                              pos_iou_thr=0.5, neg_iou_thr=0.4,
                              min_pos_iou=0.0)
    assert got.pos_mask.tolist() == c['pos']
    assert got.ignore_mask.tolist() == c['ign']
    for i, g in c['assigned'].items():
        assert int(got.assigned_gt[i]) == g
    np.testing.assert_array_equal(got.pos_mask.numpy(),
                                  np.asarray(want.pos_mask))
    np.testing.assert_array_equal(got.ignore_mask.numpy(),
                                  np.asarray(want.ignore_mask))
    np.testing.assert_array_equal(got.assigned_gt.numpy(),
                                  np.asarray(want.assigned_gt))
    np.testing.assert_allclose(got.max_iou.numpy(),
                               np.asarray(want.max_iou), atol=1e-6)


@pytest.mark.parametrize('with_ignore', [False, True])
def test_max_iou_targets_match_jax(with_ignore):
    """All seven fields over candidate boxes jittered around the GTs (so all
    three of positive, ignored and negative occur), with a padded GT, an
    invalid margin and, optionally, crowd regions (one padded) that take
    candidates out of both sets. Exact for the integer fields, 1e-6 for the
    rest (copies of the inputs or 0/1 masks)."""
    grids, valid, boxes, labels, kpts, mask = _target_case(29)
    rng = np.random.RandomState(30)
    B, P = valid.shape
    pick = rng.randint(0, boxes.shape[1], (B, P))
    cand = boxes[np.arange(B)[:, None], pick] \
        + rng.uniform(-14, 14, (B, P, 4)).astype(np.float32)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    jkw, tkw = dict(kw), dict(kw)
    if with_ignore:
        ign = np.asarray([[[10, 10, 60, 50], [0, 0, 0, 0]],
                          [[30, 20, 90, 64], [0, 0, 0, 0]]], np.float32)
        ign_mask = np.asarray([[True, False], [True, False]])
        jkw.update(gt_bboxes_ignore=jnp.asarray(ign),
                   gt_ignore_mask=jnp.asarray(ign_mask), ignore_iof_thr=0.5)
        tkw.update(gt_bboxes_ignore=_t(ign), gt_ignore_mask=_t(ign_mask),
                   ignore_iof_thr=0.5)
    want = jtargets.max_iou_targets(
        jnp.asarray(cand), jnp.asarray(valid), jnp.asarray(boxes),
        jnp.asarray(labels), jnp.asarray(kpts), jnp.asarray(mask), **jkw)
    got = ttargets.max_iou_targets(_t(cand), _t(valid), _t(boxes),
                                   _t(labels), _t(kpts), _t(mask), **tkw)
    n_pos = int(np.asarray(want.labels != 0).sum())
    n_ign = int((np.asarray(want.label_weights) == 0).sum()
                - (~valid).sum())
    assert n_pos > 4 and n_ign > 4
    for name in ttargets.PointTargets._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if name in ('labels', 'num_pos'):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6, err_msg=name)


def test_serial_loss_terms_match_jax():
    """Each of the five terms of two levels, both positive counts and the
    total, f32, 1e-5 relative."""
    rng = np.random.RandomState(31)
    K = 5
    grids, valid, boxes, labels, kpts, mask = _target_case(31, K)
    levels = [(grids[:96], valid[:, :96], (8, 12)),
              (grids[96:], valid[:, 96:], (4, 6))]
    head = HeadConfig(num_keypts=K, loss_cls_weights=(1.0,),
                      loss_bbox_weights=(0.5, 1.0),
                      loss_kpt_weights=(2.0, 4.0), smooth_l1_beta=0.11)
    jouts, touts, jti, tti, jtr, ttr = [], [], [], [], [], []
    for g, v, (h, w) in levels:
        outs = {'cls': rng.randn(1, 2, h, w, 13).astype(np.float32) * 2,
                'kpt': rng.randn(2, 2, h, w, 2 * K).astype(np.float32) * 2,
                'bbox': rng.randn(2, 2, h, w, 4).astype(np.float32) * 2}
        jouts.append({k: jnp.asarray(a) for k, a in outs.items()})
        touts.append({k: _t(a) for k, a in outs.items()})
        args = (boxes, labels, kpts, mask)
        jti.append(jtargets.point_targets(
            jnp.asarray(g), jnp.asarray(v), *map(jnp.asarray, args),
            scale=4, pos_num=2))
        tti.append(ttargets.point_targets(_t(g), _t(v), *map(_t, args),
                                          scale=4, pos_num=2))
        cand = np.tile(boxes[:, :1], (1, len(g), 1)) \
            + rng.uniform(-12, 12, (2, len(g), 4)).astype(np.float32)
        jtr.append(jtargets.max_iou_targets(
            jnp.asarray(cand), jnp.asarray(v), *map(jnp.asarray, args)))
        ttr.append(ttargets.max_iou_targets(_t(cand), _t(v),
                                            *map(_t, args)))
    want_total, want = jloss.serial_loss(
        jouts, [jnp.asarray(g) for g, _, _ in levels], jti, jtr, head)
    got_total, got = tloss.serial_loss(
        touts, [_t(g) for g, _, _ in levels], tti, ttr, head)
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
        assert float(want[k]) > 0, k
    np.testing.assert_allclose(got_total.item(), float(want_total), rtol=1e-5)
