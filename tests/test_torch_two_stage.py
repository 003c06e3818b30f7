"""The box-only two-stage detectors' parts in the port (kgdet_tpu_torch:
ops/roi.py, ops/misc_ops.py, core/two_stage_loss.py, the proposal and RoI
functions of models/two_stage.py, the two-stage table of
models/families.py, the proposal file of data/dataset.py) against
kgdet_tpu on the CPU, on seeded NumPy inputs.

RoIAlign, RoIPool, deformable RoI pooling and the masked conv within 1e-4
(RoIAlign's map gradient and deformable RoI pooling's offset gradient
too); the four samplers on the JAX package's own uniforms (jax.random's
draws fed to the port's selection), masks equal; the proposals and the
RoIs' levels equal in f32 (the boxes within an ulp of the decode's exp),
on random logits and on logits with bf16-like ties; ``rpn_loss`` and
``rcnn_targets_and_loss`` on JAX's uniforms (terms 1e-5 relative, their
gradients 1e-5 of scale); the four decodes (labels
and ``valid`` equal, boxes and scores 1e-4); the eight box-only config
files built on the CPU with the reference names; the dataset's proposal
file against the JAX dataset's samples. The detectors themselves are in
tests/test_torch_two_stage_models.py.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgdet_tpu.config import DataConfig as JDataConfig
from kgdet_tpu.config import TestConfig as TestCfg
from kgdet_tpu.core import two_stage_loss as jtsl
from kgdet_tpu.data import dataset as jdataset
from kgdet_tpu.models import families as jfamilies
from kgdet_tpu.models import two_stage as jts
from kgdet_tpu.ops import misc_ops as jmisc
from kgdet_tpu.ops import roi as jroi
from kgdet_tpu.ops.anchors import base_anchors as jbase_anchors
from kgdet_tpu.ops.anchors import grid_anchors as jgrid_anchors
from kgdet_tpu.utils.torch_convert import convert_state_dict
from kgdet_tpu_torch.api import build_model
from kgdet_tpu_torch.config import DataConfig, load_config
from kgdet_tpu_torch.core import two_stage_loss as tsl
from kgdet_tpu_torch.data import dataset as tdataset
from kgdet_tpu_torch.models import families
from kgdet_tpu_torch.models import two_stage as ts
from kgdet_tpu_torch.ops import misc_ops, roi
from kgdet_tpu_torch.ops.anchors import base_anchors, grid_anchors
from tests.test_data import make_synth_coco

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close_scaled(got, want, rel, err_msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=rel, err_msg=err_msg,
                               atol=rel * max(np.abs(want).max(), 1e-12))


def _boxes(rng, *shape, lo=-5.0, hi=90.0, size=(2.0, 50.0)):
    ctr = rng.uniform(lo, hi, (*shape, 2))
    wh = rng.uniform(*size, (*shape, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1) \
        .astype(np.float32)


def jax_uniforms(key, B, P, pos_balanced=False, neg_balanced=False):
    """The uniforms the JAX samplers draw for a batch from ``key``, in the
    port's (B, 4, P) layout: per image ``split(key, B)``, then
    sample_pos_neg's (k1, k2), each split once more where its role is
    balanced."""
    out = np.zeros((B, 4, P), np.float32)
    for b, kb in enumerate(jax.random.split(key, B)):
        for role, (k, balanced) in enumerate(
                zip(jax.random.split(kb), (pos_balanced, neg_balanced))):
            ks = jax.random.split(k) if balanced else (k,)
            for j, kk in enumerate(ks):
                out[b, 2 * role + j] = np.asarray(
                    jax.random.uniform(kk, (P,)))
    return out


# ---------------------------------------------------------------- RoI ops
def _roi_inputs(seed=0, B=2, H=9, W=13, C=5, R=6):
    rng = np.random.RandomState(seed)
    feat = rng.randn(B, H, W, C).astype(np.float32)
    boxes = _boxes(rng, B, R, lo=-5.0, hi=60.0, size=(0.5, 40.0))
    rois = np.concatenate([np.repeat(np.arange(B), R)[:, None]
                           .astype(np.float32), boxes.reshape(-1, 4)], 1)
    return rng, feat, boxes, rois


@pytest.mark.parametrize('out_size,scale,sample_num', [
    (7, 0.25, 2), (3, 0.125, 1), (4, 0.5, 3)])
def test_roi_align_and_its_map_gradient_match_jax(out_size, scale,
                                                  sample_num):
    """Per-image boxes against the JAX function's (R, 5) rois over the
    same boxes: values and the map's gradient within 1e-4 of scale."""
    rng, feat, boxes, rois = _roi_inputs()
    B, R = boxes.shape[:2]
    g = rng.randn(B * R, out_size, out_size, feat.shape[-1]) \
        .astype(np.float32)

    def jf(f):
        out = jroi.roi_align(f, jnp.asarray(rois), out_size, scale,
                             sample_num)
        return (out * g).sum(), out
    (_, want), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(feat))
    f = _t(feat).requires_grad_(True)
    got = roi.roi_align(f, _t(boxes), out_size, scale, sample_num)
    (got * _t(g).reshape(got.shape)).sum().backward()
    _close_scaled(got.reshape(want.shape), want, 1e-4)
    _close_scaled(f.grad, jgrad, 1e-4)


@pytest.mark.parametrize('out_size,scale', [(7, 0.25), (3, 1.0)])
def test_roi_pool_matches_jax(out_size, scale):
    """Max over each bin's rounded cells, empty bins 0: equal."""
    _, feat, boxes, rois = _roi_inputs(seed=1)
    want = jroi.roi_pool(jnp.asarray(feat), jnp.asarray(rois), out_size,
                         scale)
    got = roi.roi_pool(_t(feat), _t(boxes), out_size, scale)
    np.testing.assert_array_equal(_np(got).reshape(want.shape),
                                  np.asarray(want))


def test_deform_roi_pooling_and_masked_conv_match_jax():
    """Deformable RoI pooling (values and the offsets' gradient) and the
    masked conv (stride 1 and 2) within 1e-4 of scale."""
    rng, feat, boxes, rois = _roi_inputs(seed=2)
    B, R = boxes.shape[:2]
    off = (rng.randn(B, R, 7, 7, 2) * 0.3).astype(np.float32)
    mod = rng.rand(B, R, 7, 7).astype(np.float32)
    g = rng.randn(B * R, 7, 7, feat.shape[-1]).astype(np.float32)

    def jf(o):
        out = jmisc.deform_roi_pooling(
            jnp.asarray(feat), jnp.asarray(rois), o.reshape(-1, 7, 7, 2), 7,
            0.25, 2, 0.1, jnp.asarray(mod.reshape(-1, 7, 7)))
        return (out * g).sum(), out
    (_, want), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(
        jnp.asarray(off))
    o = _t(off).requires_grad_(True)
    got = misc_ops.deform_roi_pooling(_t(feat), _t(boxes), o, 7, 0.25, 2,
                                      0.1, _t(mod))
    (got * _t(g).reshape(got.shape)).sum().backward()
    _close_scaled(got.reshape(want.shape), want, 1e-4)
    _close_scaled(o.grad, jgrad, 1e-4)
    w = rng.randn(3, 3, feat.shape[-1], 4).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    for stride in (1, 2):
        H, W = -(-feat.shape[1] // stride), -(-feat.shape[2] // stride)
        m = (rng.rand(B, H, W) > 0.5).astype(np.float32)
        want = jmisc.masked_conv2d(jnp.asarray(feat), jnp.asarray(m),
                                   jnp.asarray(w), jnp.asarray(b),
                                   stride=stride)
        got = misc_ops.masked_conv2d(_t(feat), _t(m), _t(w), _t(b), stride)
        _close_scaled(got, want, 1e-4)


# ---------------------------------------------------------------- samplers
def _vmapped_jax_sampler(key, pos, neg, num, frac, **kw):
    keys = jax.random.split(key, pos.shape[0])
    names = sorted(kw)

    def one(k, p, n, *extra):
        return jtsl.sample_pos_neg(k, p, n, num, frac,
                                   **dict(zip(names, extra)))
    return jax.jit(jax.vmap(one))(keys, jnp.asarray(pos), jnp.asarray(neg),
                                  *[jnp.asarray(kw[n]) for n in names])


@pytest.mark.parametrize('sampler', ['random', 'ohem', 'instance_balanced',
                                     'iou_balanced'])
@pytest.mark.parametrize('num', [64, 1000])
def test_samplers_match_jax_on_its_uniforms(sampler, num):
    """sample_pos_neg of both packages on JAX's uniforms for the same
    key: the positive and negative masks equal (with quotas under and
    over the candidates)."""
    rng = np.random.RandomState(5)
    B, P = 3, 400
    pos = rng.rand(B, P) < 0.15
    neg = ~pos & (rng.rand(B, P) < 0.8)
    kw = {}
    if sampler == 'ohem':
        kw['neg_priority'] = rng.randn(B, P).astype(np.float32)
    elif sampler == 'instance_balanced':
        kw['pos_group_id'] = rng.randint(0, 5, (B, P)).astype(np.int32)
    elif sampler == 'iou_balanced':
        kw['neg_group_id'] = rng.randint(0, 3, (B, P)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want = _vmapped_jax_sampler(key, pos, neg, num, 0.25, **kw)
    u = jax_uniforms(key, B, P, pos_balanced='pos_group_id' in kw,
                     neg_balanced='neg_group_id' in kw)
    got = tsl.sample_pos_neg(_t(u), _t(pos), _t(neg), num, 0.25,
                             **{k: _t(v) for k, v in kw.items()})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    assert _np(got[0]).any() and _np(got[1]).any()


def test_sampler_draw_is_per_image_and_global(monkeypatch):
    """Image i of a batch draws the same uniforms as image i of a share
    that starts at i (one process and data-parallel processes agree);
    roles and seeds draw differently."""
    draw = tsl.sampler_draw(7, 4, 'cpu')
    u = draw(tsl.RPN_ROLE, 50)
    assert u.shape == (4, 4, 50) and ((u >= 0) & (u < 1)).all()
    torch.testing.assert_close(draw(tsl.RPN_ROLE, 50), u, rtol=0, atol=0)
    assert not torch.equal(draw(tsl.rcnn_role(0), 50), u)
    assert not torch.equal(tsl.sampler_draw(8, 4, 'cpu')(0, 50), u)
    monkeypatch.setattr(tsl, 'world', lambda: (1, 2))
    share = tsl.sampler_draw(7, 2, 'cpu')(tsl.RPN_ROLE, 50)
    torch.testing.assert_close(share, u[2:], rtol=0, atol=0)


# ------------------------------------------------------ proposals, levels
def _rpn_case(rng, ties, B=2, levels=((8, 12), (4, 6), (2, 3)), A=3):
    outs, janchors, anchors = [], [], []
    for (h, w), s in zip(levels, (8, 16, 32)):
        cls = rng.randn(1, B, h, w, A).astype(np.float32)
        if ties:                    # a handful of distinct logits
            cls = np.round(cls * 2) / 2
        outs.append({'cls': cls, 'bbox': (rng.randn(1, B, h, w, A * 4)
                                          * 0.2).astype(np.float32)})
        base = jbase_anchors(s, [8.0], (0.5, 1.0, 2.0))
        janchors.append(jgrid_anchors(base, h, w, s))
        anchors.append(grid_anchors(base_anchors(s, [8.0], (0.5, 1.0, 2.0)),
                                    h, w, s))
    return outs, janchors, anchors


@pytest.mark.parametrize('ties', [False, True])
def test_rpn_proposals_and_levels_match_jax(ties):
    """rpn_proposals (stable descending sort per level, one NMS over the
    levels for both images) in f32: the same proposals in the same order,
    on random logits and on logits of a few values (the ties of bf16
    scores); map_rois_to_levels equal."""
    rng = np.random.RandomState(3)
    outs, janchors, anchors = _rpn_case(rng, ties)
    img_hw = np.asarray([[60., 90.], [64., 96.]], np.float32)
    kw = dict(nms_pre=40, max_num=30, nms_thr=0.7, min_bbox_size=1.0)
    want = jts.rpn_proposals(
        [{k: jnp.asarray(v) for k, v in o.items()} for o in outs],
        janchors, jnp.asarray(img_hw), **kw)
    got = ts.rpn_proposals([{k: _t(v) for k, v in o.items()} for o in outs],
                           anchors, _t(img_hw), **kw)
    # the same proposals in the same order: scores and valid bit-equal,
    # boxes within f32 rounding of the decode's exp (an ulp at 96 px)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), rtol=1e-6,
                               atol=1e-5)
    assert _np(got[2]).sum() > 20
    wh = np.concatenate([rng.uniform(1, 600, (50, 2)),
                         np.asarray([[56., 56.], [112., 112.], [224., 224.],
                                     [0., 5.]])]).astype(np.float32)
    for n in (3, 5):
        np.testing.assert_array_equal(
            _np(ts.map_rois_to_levels(_t(wh), n)),
            np.asarray(jts.map_rois_to_levels(jnp.asarray(wh), n)))


def test_extract_roi_feats_matches_jax():
    """Every level gathered, each RoI's picked with where; invalid RoIs
    zero: within 1e-4 of scale."""
    rng = np.random.RandomState(4)
    feats = [rng.randn(2, 16 // s, 24 // s, 6).astype(np.float32)
             for s in (1, 2, 4)]
    props = _boxes(rng, 2, 20, lo=0, hi=90, size=(2, 300))
    valid = rng.rand(2, 20) > 0.2
    want = jax.jit(lambda f, p, v: jts.extract_roi_feats(
        f, (8, 16, 32), p, v))([jnp.asarray(f) for f in feats],
                               jnp.asarray(props), jnp.asarray(valid))
    got = ts.extract_roi_feats([_t(f) for f in feats], (8, 16, 32),
                               _t(props), _t(valid))
    _close_scaled(got, want, 1e-4)


# ------------------------------------------------------------------ losses
def _gt_batch(rng, B=2, G=5):
    gts = _boxes(rng, B, G, lo=10, hi=80, size=(8, 40))
    mask = np.ones((B, G), bool)
    mask[:, -1] = False
    return {'gt_bboxes': gts,
            'gt_labels': rng.randint(1, 14, (B, G)).astype(np.int32),
            'gt_mask': mask}


def test_rpn_loss_and_gradients_match_jax():
    """rpn_loss on JAX's uniforms: both terms within 1e-5 relative, the
    gradients of the objectness and delta maps within 1e-5 of scale."""
    rng = np.random.RandomState(6)
    outs, janchors, anchors = _rpn_case(rng, False)
    valids = [rng.rand(2, a.shape[0]) > 0.1 for a in anchors]
    batch = _gt_batch(rng)
    key = jax.random.PRNGKey(2)
    n = sum(a.shape[0] for a in anchors)

    def jloss(o):
        lc, lr = jtsl.rpn_loss(o, janchors, [jnp.asarray(v) for v in valids],
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               key)
        return lc + 3 * lr, (lc, lr)
    jouts = [{k: jnp.asarray(v) for k, v in o.items()} for o in outs]
    (_, jterms), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jouts)
    touts = [{k: _t(v).requires_grad_(True) for k, v in o.items()}
             for o in outs]
    terms = tsl.rpn_loss(touts, anchors, [_t(v) for v in valids],
                         {k: _t(v) for k, v in batch.items()},
                         _t(jax_uniforms(key, 2, n)))
    (terms[0] + 3 * terms[1]).backward()
    for g, w in zip(terms, jterms):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    for o, jo in zip(touts, jgrads):
        for k in o:
            _close_scaled(o[k].grad, jo[k], 1e-5, k)


@pytest.mark.parametrize('sampler', ['random', 'ohem', 'instance_balanced',
                                     'iou_balanced'])
def test_rcnn_targets_and_loss_match_jax(sampler):
    """rcnn_targets_and_loss with each sampler on JAX's uniforms: labels
    equal, the terms and accuracy within 1e-5 relative, the gradients of
    the class logits and deltas within 1e-5 of scale."""
    rng = np.random.RandomState(7)
    B, R = 2, 80
    batch = _gt_batch(rng)
    props = np.concatenate([_boxes(rng, B, R - 10, lo=10, hi=80,
                                   size=(8, 40)),
                            batch['gt_bboxes'][:, :5] + rng.randn(B, 5, 4)
                            .astype(np.float32),
                            batch['gt_bboxes'][:, :5]], 1)
    valid = rng.rand(B, R) > 0.1
    cls = rng.randn(B, R, 14).astype(np.float32)
    reg = (rng.randn(B, R, 56) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    kw = dict(num_samples=64, sampler=sampler)

    def jloss(c, r):
        lc, lr, aux = jtsl.rcnn_targets_and_loss(
            jnp.asarray(props), jnp.asarray(valid), c, r,
            {k: jnp.asarray(v) for k, v in batch.items()}, key, 13, **kw)
        return lc + 2 * lr, (lc, lr, aux)
    (_, (jc, jr, jaux)), (gc, gr) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(cls),
                                              jnp.asarray(reg))
    c, r = _t(cls).requires_grad_(True), _t(reg).requires_grad_(True)
    u = jax_uniforms(key, B, R, pos_balanced=sampler == 'instance_balanced',
                     neg_balanced=sampler == 'iou_balanced')
    lc, lr, aux = tsl.rcnn_targets_and_loss(
        _t(props), _t(valid), c, r, {k: _t(v) for k, v in batch.items()},
        _t(u), 13, **kw)
    (lc + 2 * lr).backward()
    np.testing.assert_array_equal(_np(aux['labels']),
                                  np.asarray(jaux['labels']))
    assert (_np(aux['labels']) > 0).sum() > 5
    for g, w in ((lc, jc), (lr, jr), (aux['acc'], jaux['acc'])):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    _close_scaled(c.grad, gc, 1e-5)
    _close_scaled(r.grad, gr, 1e-5)


# ----------------------------------------------------------------- decodes
def _fwd_case(rng, detector_type, B=2, R=40, C=13):
    props = _boxes(rng, B, R, lo=10, hi=80, size=(4, 40))
    valid = rng.rand(B, R) > 0.2

    def stage(agnostic):
        return {'proposals': props,
                'roi_cls': (rng.randn(B, R, C + 1) * 2).astype(np.float32),
                'roi_reg': (rng.randn(B, R, 4 if agnostic else 4 * (C + 1))
                            * 0.5).astype(np.float32)}
    fwd = {'proposals': props, 'proposal_valid': valid,
           'proposal_scores': rng.rand(B, R).astype(np.float32)}
    if detector_type == 'cascade_rcnn':
        fwd['stages'] = [stage(True) for _ in range(3)]
    else:
        fwd.update(stage(False))
    return fwd


@pytest.mark.parametrize('detector_type', ['faster_rcnn', 'fast_rcnn',
                                           'cascade_rcnn', 'rpn'])
def test_decodes_match_jax(detector_type):
    """two_stage_decoder of both packages on the same forward outputs:
    labels and valid equal, boxes and scores within 1e-4."""
    rng = np.random.RandomState(8)
    fwd = _fwd_case(rng, detector_type)
    img_hw = np.asarray([[60., 90.], [64., 96.]], np.float32)
    sf = np.asarray([1.0, 0.75], np.float32)
    test_cfg = TestCfg(score_thr=0.05, nms_iou_thr=0.5, max_per_class=10,
                       max_per_img=20)

    def conv(tree, f):
        if isinstance(tree, dict):
            return {k: conv(v, f) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v, f) for v in tree]
        return f(tree)
    want = jfamilies.two_stage_decoder(detector_type)(
        conv(fwd, jnp.asarray), jnp.asarray(img_hw), jnp.asarray(sf),
        test_cfg, 13)
    got = families.two_stage_decoder(detector_type)(
        conv(fwd, _t), _t(img_hw), _t(sf), test_cfg, 13)
    assert sorted(got) == sorted(want)
    for k in ('valid', 'det_labels'):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), k)
    np.testing.assert_allclose(_np(got['det_bboxes']),
                               np.asarray(want['det_bboxes']), rtol=1e-4,
                               atol=1e-4)
    assert _np(got['det_kpts']).shape[-1] == 3 and not _np(
        got['det_kpts']).any()
    assert _np(got['valid']).sum() > 5


def test_mask_grid_htc_and_ga_rpn_raise_naming_item_6():
    """The detectors with masks or grids, HTC and GA-RPN, which raised
    NotImplementedError naming item 6 until they were ported, now build
    (the three mask config files as they ship, Grid R-CNN and the GA-RPN
    Faster R-CNN in code) and have the JAX package's loss and decode
    entries; unknown names raise KeyError, as in the JAX package."""
    cfg = load_config(os.path.join(
        ROOT, 'configs', 'faster_rcnn_r50_fpn_1x_deepfashion2.py'))
    for path, cls in (('mask_rcnn', ts.FasterRCNN), ('ms_rcnn',
                                                      ts.FasterRCNN),
                      ('htc', ts.CascadeRCNN)):
        other = load_config(os.path.join(
            ROOT, 'configs', f'{path}_r50_fpn_1x_deepfashion2.py'))
        assert type(build_model(other, device='cpu')) is cls
    grid = build_model(cfg.replace(detector_type='grid_rcnn'), device='cpu')
    ga = build_model(cfg.replace(rpn_type='ga_rpn'), device='cpu')
    assert hasattr(grid, 'grid_head') and type(ga.rpn_head).__name__ == \
        'GARPNHead'
    for dt in ('mask_rcnn', 'ms_rcnn', 'grid_rcnn', 'htc'):
        assert tsl.two_stage_loss_fn(dt).__name__ == \
            jtsl.two_stage_loss_fn(dt).__name__
        assert families.two_stage_decoder(dt).__name__ == \
            jfamilies.two_stage_decoder(dt).__name__
    with pytest.raises(KeyError, match='unknown two-stage detector'):
        families.two_stage_decoder('nope')
    with pytest.raises(KeyError, match='unknown two-stage detector'):
        jfamilies.two_stage_decoder('nope')
    with pytest.raises(KeyError, match='unknown two-stage detector'):
        tsl.two_stage_loss_fn('nope')
    assert families.TWO_STAGE_TYPES == jfamilies.TWO_STAGE_TYPES
    assert families.is_two_stage('rpn') and not families.is_two_stage(
        'single_stage')


# ------------------------------------------------------------ config files
BOX_ONLY = ('rpn_r50_fpn', 'faster_rcnn_r50_fpn', 'fast_rcnn_r50_fpn',
            'cascade_rcnn_r50_fpn', 'faster_rcnn_r50_caffe_c4',
            'libra_faster_rcnn_r50_fpn', 'faster_rcnn_x101_32x4d_fpn',
            'faster_rcnn_hrnetv2p_w32')
DETECTORS = {'rpn': ts.RPNDetector, 'cascade_rcnn': ts.CascadeRCNN,
             'faster_rcnn': ts.FasterRCNN, 'fast_rcnn': ts.FasterRCNN}


@pytest.mark.parametrize('name', BOX_ONLY)
def test_config_files_build_on_the_cpu(name):
    """Each of the eight box-only config files as it ships: load_config
    and build_model on the CPU, the detector class of its type, its
    state_dict mapped by the JAX converter with nothing skipped."""
    cfg = load_config(os.path.join(ROOT, 'configs',
                                   f'{name}_1x_deepfashion2.py'))
    model = build_model(cfg, device='cpu')
    assert type(model) is DETECTORS[cfg.detector_type]
    _, _, skipped = convert_state_dict(model.state_dict())
    assert skipped == []
    names = dict(model.named_parameters())
    if cfg.detector_type != 'fast_rcnn':
        assert names['rpn_head.rpn_cls.weight'].shape[0] == \
            len(cfg.head.anchor_scales) * len(cfg.head.anchor_ratios)
    else:
        assert not hasattr(model, 'rpn_head')
    if 'c4' in name:
        assert names['shared_head.layer4.0.conv1.weight'].shape == \
            (512, 1024, 1, 1)
        assert model.shared_head.layer4[0].conv1.stride == (2, 2)
        assert names['bbox_head.fc_cls.weight'].shape == (14, 2048)
    elif cfg.detector_type == 'cascade_rcnn':
        assert names['bbox_head.2.fc_reg.weight'].shape == (4, 1024)
    elif cfg.detector_type != 'rpn':
        assert names['bbox_head.shared_fcs.0.weight'].shape == \
            (1024, 256 * 49)
        assert names['bbox_head.fc_reg.weight'].shape == (56, 1024)


# ------------------------------------------------------- the proposal file
@pytest.mark.parametrize('form', ['list', 'dict'])
def test_proposal_file_samples_match_jax(form, tmp_path):
    """A .pkl of proposals (a list in image order with scores, or a dict by
    file name without): the train samples (flip on) and the test samples
    carry proposals and proposals_valid equal to the JAX dataset's."""
    d = str(tmp_path)
    ann = make_synth_coco(d, n_images=6)
    rng = np.random.RandomState(9)
    jds = jdataset.DeepFashion2Dataset(
        JDataConfig(ann_file=ann, img_prefix=d), train=False)
    props = [np.concatenate([_boxes(rng, n, lo=10, hi=120, size=(5, 60)),
                             rng.rand(n, 1).astype(np.float32)], 1)
             for n in (12, 3, 0, 7, 20, 1)]
    if form == 'dict':
        raw = {r.filename: p[:, :4] for r, p in zip(jds.records, props)}
    else:
        raw = props
    path = os.path.join(d, 'proposals.pkl')
    with open(path, 'wb') as f:
        pickle.dump(raw, f)
    kw = dict(ann_file=ann, img_prefix=d, img_scale=(128, 96),
              canvas_hw=((96, 128), (128, 96)), proposal_file=path,
              num_proposals=10, flip_ratio=0.5, max_gts=8)
    for train in (True, False):
        jd = jdataset.DeepFashion2Dataset(JDataConfig(**kw), train=train)
        td = tdataset.DeepFashion2Dataset(DataConfig(**kw), train=train)
        assert len(jd) == len(td) > 0
        for i in range(len(td)):
            if train:
                got = td.prepare_train(i, np.random.RandomState(i))
                want = jd.prepare_train(i, np.random.RandomState(i))
            else:
                got, want = td.prepare_test(i), jd.prepare_test(i)
            for k in ('proposals', 'proposals_valid'):
                np.testing.assert_array_equal(got[k], want[k], k)
