"""Port ops (kgdet_tpu_torch.ops) against their kgdet_tpu counterparts.

Same inputs, made with numpy from a seed, go through the JAX function and
the port's; f32 throughout, tolerance 1e-4 (tests/test_reference_parity.py)
unless stated.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kgdet_tpu.ops import deform as jdeform
from kgdet_tpu.ops import image as jimage
from kgdet_tpu.ops import nms as jnms
from kgdet_tpu.ops import points as jpoints
from kgdet_tpu.ops.pallas_deform import _prep_indices as j_prep_indices
from kgdet_tpu_torch.ops import deform, image, nms, points
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
    assert (dk.deform_conv_fused.launches, sk.stem_pool.launches,
            sk.frozen_bottleneck.launches) == before
