"""The anchor-based families of the port (kgdet_tpu_torch: ops/anchors.py,
core/bbox_transforms.py, core/anchor_loss.py, models/retina_head.py,
models/vgg.py, models/ssd_head.py) against kgdet_tpu.

Seeded NumPy inputs go through both packages on the CPU in f32, models with
the same weights (flax variables carried into the port through
``utils/convert.py::state_dict_from_jax``): anchors bit for bit, box
transforms within 1e-6, anchor targets (labels and weights equal, deltas
1e-5), both losses' terms and their gradients with respect to the head
outputs (1e-4 of scale, the SSD hard-negative quota included), both
decodes (boxes 1e-4, labels and ``valid`` equal), whole tiny RetinaNet and
SSD models (head outputs, loss terms, every parameter's gradient,
detections), the SSD300 trunk and head of the shipped config at 300x300,
the state-dict round trips and ``.pth`` routes, the evaluation of the
width-3 dummy keypoints, and tools/benchmark.py. Tolerances are stated at
each assert.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.api import make_predict_fn as jmake_predict_fn
from kgdet_tpu.config import AssignConfig, BackboneConfig, DataConfig, \
    HeadConfig, KGDetConfig, NeckConfig, OptimConfig
from kgdet_tpu.config import TestConfig as TestCfg
from kgdet_tpu.config import load_config as jload_config
from kgdet_tpu.core import anchor_loss as janchor_loss
from kgdet_tpu.core import bbox_transforms as jbt
from kgdet_tpu.ops import anchors as janchors
from kgdet_tpu.parallel import train as jtrain
from kgdet_tpu.utils.torch_convert import (convert_state_dict,
                                           merge_into_variables)
from kgdet_tpu_torch.api import build_model, init_trainer, make_predict_fn
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.core import anchor_loss
from kgdet_tpu_torch.core import bbox_transforms as bt
from kgdet_tpu_torch.ops import anchors
from kgdet_tpu_torch.parallel import train as ttrain
from kgdet_tpu_torch.utils.convert import (load_reference_state,
                                           state_dict_from_jax)
from tests.common import synth_batch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD300 = os.path.join(ROOT, 'configs', 'ssd300_vgg16_deepfashion2.py')
CANVAS = (64, 96)
STRIDES = (8, 16, 32)
SSD_RATIOS = ((2,), (2, 3), (2,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# ------------------------------------------------------------------ anchors
@pytest.mark.parametrize('size,scales,ratios,ctr', [
    (8, [1.0, 2 ** (1 / 3), 2 ** (2 / 3)], [0.5, 1.0, 2.0], None),
    (4 * 32, [1.0], [1.0], None),
    (21, [1.0], [1 / 3, 3.0], (3.5, 3.5)),
])
def test_base_and_grid_anchors_bit_equal(size, scales, ratios, ctr):
    want = janchors.base_anchors(size, scales, ratios, ctr)
    got = anchors.base_anchors(size, scales, ratios, ctr)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    for fh, fw, stride in ((5, 7, 8), (1, 3, 128), (38, 38, 8)):
        np.testing.assert_array_equal(
            _np(anchors.grid_anchors(got, fh, fw, stride)),
            np.asarray(janchors.grid_anchors(want, fh, fw, stride)))


def test_anchor_valid_flags_and_ssd_recipes_bit_equal():
    for args in ((2, 2, 3, 1, 2), (5, 7, 9, 3, 7), (4, 6, 4, 0, 6)):
        np.testing.assert_array_equal(
            _np(anchors.anchor_valid_flags(*args)),
            np.asarray(janchors.anchor_valid_flags(*args)))
    vh, vw = np.asarray([3, 5], np.int32), np.asarray([7, 2], np.int32)
    got = anchors.anchor_valid_flags(5, 7, 6, _t(vh), _t(vw))
    want = jax.vmap(lambda a, b: janchors.anchor_valid_flags(5, 7, 6, a, b))(
        jnp.asarray(vh), jnp.asarray(vw))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    for size, levels, rng in ((300, 6, (0.15, 0.9)), (300, 5, (0.2, 0.9)),
                              (512, 7, (0.1, 0.9)), (400, 5, (0.3, 0.9))):
        want = janchors.ssd_anchor_params(size, levels, rng)
        assert anchors.ssd_anchor_params(size, levels, rng) == want
        for i, (lo, hi) in enumerate(zip(*want)):
            np.testing.assert_array_equal(
                anchors.ssd_base_anchors(lo, hi, 8 * 2 ** i, (2, 3)),
                janchors.ssd_base_anchors(lo, hi, 8 * 2 ** i, (2, 3)))


# --------------------------------------------------------- box transforms
def _boxes(rng, *shape):
    xy = rng.uniform(0, 80, (*shape, 2))
    return np.concatenate([xy, xy + rng.uniform(1, 60, (*shape, 2))],
                          -1).astype(np.float32)


def _close(got, want, err_msg=''):
    """f32 within 1e-6 of the output's scale: exp and log round by an ulp
    differently in the two libraries, which the box arithmetic carries."""
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-6, err_msg=err_msg,
                               atol=1e-6 * max(1.0, np.abs(want).max()))


def test_bbox_transforms_match_jax():
    """Every function of the module, f32, within 1e-6 of scale."""
    rng = np.random.RandomState(0)
    props, gts = _boxes(rng, 3, 50), _boxes(rng, 3, 50)
    deltas = rng.randn(3, 50, 4).astype(np.float32) * 2
    means, stds = (0.1, -0.2, 0.0, 0.3), (0.1, 0.1, 0.2, 0.2)
    for kw in ({}, {'means': means, 'stds': stds}):
        _close(bt.bbox2delta(_t(props), _t(gts), **kw),
               jbt.bbox2delta(jnp.asarray(props), jnp.asarray(gts), **kw))
    for kw in ({}, {'means': means, 'stds': stds, 'max_shape': (60, 90)},
               {'wh_ratio_clip': 0.5}):
        _close(bt.delta2bbox(_t(props), _t(deltas), **kw),
               jbt.delta2bbox(jnp.asarray(props), jnp.asarray(deltas), **kw),
               str(kw))
    pts = rng.uniform(0, 100, (3, 50, 2)).astype(np.float32)
    dist = rng.uniform(0, 40, (3, 50, 4)).astype(np.float32)
    for shape in (None, (60, 90)):
        _close(bt.distance2bbox(_t(pts), _t(dist), shape),
               jbt.distance2bbox(jnp.asarray(pts), jnp.asarray(dist), shape))
    per_img = [props[0, :7], props[1, :3], props[2, :5]]
    np.testing.assert_array_equal(
        _np(bt.bbox2roi([_t(b) for b in per_img])),
        np.asarray(jbt.bbox2roi([jnp.asarray(b) for b in per_img])))
    for flip in (False, True):
        args = (props[0], (60, 90), 0.75, flip)
        np.testing.assert_array_equal(bt.bbox_mapping(*args),
                                      jbt.bbox_mapping(*args))
        np.testing.assert_array_equal(bt.bbox_mapping_back(*args),
                                      jbt.bbox_mapping_back(*args))
    dets = np.concatenate([props[0], rng.rand(50, 1)], 1)
    labels = rng.randint(0, 4, 50)
    for g, w in zip(bt.bbox2result(_t(dets), _t(labels), 4),
                    jbt.bbox2result(dets, labels, 4)):
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------- anchor targets
def _target_inputs(seed=0, B=2, G=5, P=300):
    rng = np.random.RandomState(seed)
    anc = _boxes(rng, P)
    gts = _boxes(rng, B, G)
    gts[0, 1] = anc[7] + 0.5            # a near-exact match
    return dict(
        anchors=anc, anchor_valid=rng.rand(B, P) > 0.1, gt_bboxes=gts,
        gt_labels=rng.randint(1, 14, (B, G)).astype(np.int32),
        gt_mask=np.asarray([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], bool),
        gt_bboxes_ignore=_boxes(rng, B, 2),
        gt_ignore_mask=np.asarray([[True, False], [True, True]]))


@pytest.mark.parametrize('kw', [
    dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
    dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.2,
         ignore_iof_thr=0.5),
])
def test_anchor_targets_match_jax(kw):
    """labels, label and box weights and num_pos equal; deltas within
    1e-5."""
    inputs = _target_inputs()
    want = jax.jit(lambda a: janchor_loss.anchor_targets(**a, **kw))(
        {k: jnp.asarray(v) for k, v in inputs.items()})
    got = anchor_loss.anchor_targets(**{k: _t(v) for k, v in
                                        inputs.items()}, **kw)
    assert int(np.asarray(want[4]).sum()) > 2
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(_np(g), np.asarray(w))


# ------------------------------------------------------------------ losses
def _level_outs(rng, B, shapes, width, scale=1.0):
    return [{'cls': rng.randn(1, B, h, w, a * width).astype(np.float32)
             * scale,
             'bbox': rng.randn(1, B, h, w, a * 4).astype(np.float32) * 0.3}
            for h, w, a in shapes]


def _loss_setup(head_type, seed):
    """Level outputs, anchors, valids and a batch for a 3-level canvas."""
    rng = np.random.RandomState(seed)
    if head_type == 'RetinaHead':
        bases = [janchors.base_anchors(4 * s, [1.0, 2 ** 0.5], [0.5, 1, 2])
                 for s in STRIDES]
        width = 13
    else:
        mins, maxs = janchors.ssd_anchor_params(300, 3, (0.15, 0.9))
        bases = [janchors.ssd_base_anchors(mins[i], maxs[i], STRIDES[i],
                                           SSD_RATIOS[i]) for i in range(3)]
        width = 14
    H, W = CANVAS
    shapes = [(-(-H // s), -(-W // s), len(b)) for s, b in zip(STRIDES,
                                                              bases)]
    anc = [np.asarray(janchors.grid_anchors(b, h, w, s))
           for b, (h, w, _), s in zip(bases, shapes, STRIDES)]
    batch = synth_batch(canvas=CANVAS, B=2, G=4, K=3, seed=seed)
    batch['valid_hw'] = np.asarray([[64, 96], [48, 72]], np.int32)
    valids = [np.asarray(jax.vmap(
        lambda a, b, h=h, w=w, A=A: janchors.anchor_valid_flags(
            h, w, A, a, b))(jnp.asarray([8 // (s // 8), 6 // (s // 8)]),
                            jnp.asarray([12 // (s // 8), 9 // (s // 8)])))
        for (h, w, A), s in zip(shapes, STRIDES)]
    return _level_outs(rng, 2, shapes, width), anc, valids, batch


def _head_cfg(head_type):
    return HeadConfig(type=head_type, num_classes=13,
                      point_strides=STRIDES, ssd_anchor_ratios=SSD_RATIOS)


LOSS_KEYS = ('loss_cls', 'loss_bbox', 'num_pos')


@pytest.mark.parametrize('head_type', ['RetinaHead', 'SSDHead'])
def test_losses_and_their_gradients_match_jax(head_type):
    """retina_loss / ssd_loss: the terms (1e-5 relative) and the gradient
    of the total with respect to every level's cls and bbox outputs
    (jax.grad; 1e-4 of each gradient's scale). For SSD the hard negatives
    that each image's quota (3 x its positives) selects are the same."""
    outs, anc, valids, batch = _loss_setup(head_type, seed=1)
    hcfg = _head_cfg(head_type)
    acfg = AssignConfig(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jfn = janchor_loss.retina_loss if head_type == 'RetinaHead' \
        else janchor_loss.ssd_loss
    tfn = anchor_loss.retina_loss if head_type == 'RetinaHead' \
        else anchor_loss.ssd_loss

    def jloss(o):
        return jfn(o, [jnp.asarray(a) for a in anc],
                   [jnp.asarray(v) for v in valids], jb, hcfg, acfg)
    (jtotal, jlogs), jgrad = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jax.tree.map(jnp.asarray, outs))
    touts = [{k: _t(v).requires_grad_() for k, v in o.items()}
             for o in outs]
    total, logs = tfn(touts, [_t(a) for a in anc], [_t(v) for v in valids],
                      {k: _t(v) for k, v in batch.items()}, hcfg, acfg)
    total.backward()
    assert float(jlogs['num_pos']) >= 4
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                   rtol=1e-5, err_msg=k)
    for lvl, (o, g) in enumerate(zip(touts, jgrad)):
        for k in ('cls', 'bbox'):
            want = np.asarray(g[k])
            np.testing.assert_allclose(
                _np(o[k].grad), want, rtol=0, err_msg=f'{k} level {lvl}',
                atol=1e-4 * np.abs(want).max())


def test_ssd_hard_negative_quota_matches_jax():
    """tests/test_ssd.py::test_ssd_hard_negative_quota's case: one level
    at stride 8, one box; the selected negatives are exactly 3 x the
    positives, the same anchors in both packages (ties broken by the
    lower index, as jnp.argsort does), and the loss terms agree."""
    from kgdet_tpu.models.ssd_head import SSDHead as JSSDHead
    jhead = JSSDHead(num_classes=13, anchor_strides=(8,), input_size=300,
                     basesize_ratio_range=(0.15, 0.9), anchor_ratios=((2,),))
    fh, fw = 8, 12
    anc = np.asarray(janchors.grid_anchors(jhead.base_anchors_per_level()[0],
                                           fh, fw, 8))
    P = fh * fw * 4
    rng = np.random.RandomState(0)
    cls = rng.randn(1, 1, fh, fw, 4 * 14).astype(np.float32)
    cls[..., 14:28] = cls[..., :14]         # tied cross entropies
    outs = [{'cls': cls, 'bbox': np.zeros((1, 1, fh, fw, 16), np.float32)}]
    batch = {'gt_bboxes': np.asarray([[[8., 8., 30., 30.]]], np.float32),
             'gt_labels': np.asarray([[3]], np.int32),
             'gt_mask': np.ones((1, 1), bool)}
    hcfg = HeadConfig(type='SSDHead', num_classes=13)
    acfg = AssignConfig(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.2)
    _, jlogs = jax.jit(lambda o, a, b: janchor_loss.ssd_loss(
        o, a, [jnp.ones((1, P), bool)], b, hcfg, acfg))(
            jax.tree.map(jnp.asarray, outs), [jnp.asarray(anc)],
            jax.tree.map(jnp.asarray, batch))
    _, logs = anchor_loss.ssd_loss(
        [{k: _t(v) for k, v in outs[0].items()}], [_t(anc)],
        [torch.ones((1, P), dtype=torch.bool)],
        {k: _t(v) for k, v in batch.items()}, hcfg, acfg)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                   rtol=1e-6, err_msg=k)
    labels, label_w, *_ = anchor_loss.anchor_targets(
        _t(anc), torch.ones((1, P), dtype=torch.bool),
        *[_t(batch[k]) for k in ('gt_bboxes', 'gt_labels', 'gt_mask')],
        pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.2)
    ce = -torch.log_softmax(_t(cls).reshape(1, P, 14), -1).gather(
        -1, labels.long()[..., None])[..., 0]
    pos, neg = labels > 0, (labels == 0) & (label_w > 0)
    sel = anchor_loss.hard_negatives(ce, neg, pos.sum(1), 3)
    assert int(pos.sum()) >= 1 and int(sel.sum()) == 3 * int(pos.sum())
    # the JAX rule on the same CE: argsort of the negated CE, rank < quota
    neg_ce = jnp.where(jnp.asarray(_np(neg)), jnp.asarray(_np(ce)), -jnp.inf)
    order = np.asarray(jnp.argsort(-neg_ce, axis=1))
    rank = np.empty_like(order)
    rank[0, order[0]] = np.arange(P)
    np.testing.assert_array_equal(
        _np(sel), _np(neg) & (rank < 3 * int(pos.sum())))


@pytest.mark.parametrize('head_type', ['RetinaHead', 'SSDHead'])
def test_decodes_match_jax(head_type):
    """decode_detections_anchor / _ssd on the same level outputs: boxes and
    scores within 1e-4, labels, ``valid`` and the zero keypoints of width 3
    equal; nms_pre cuts every level but the last."""
    outs, anc, _, _ = _loss_setup(head_type, seed=2)
    test = TestCfg(nms_pre=60, max_per_class=10, max_per_img=20,
                   score_thr=0.02)
    img_hw = np.asarray([[64, 96], [48, 70]], np.float32)
    sf = np.asarray([1.0, 0.8], np.float32)
    if head_type == 'RetinaHead':
        want = jax.jit(lambda o, h, s: janchor_loss.decode_detections_anchor(
            o, anc, h, s, test, num_classes=13))(
                jax.tree.map(jnp.asarray, outs), jnp.asarray(img_hw),
                jnp.asarray(sf))
        got = anchor_loss.decode_detections_anchor(
            [{k: _t(v) for k, v in o.items()} for o in outs],
            [_t(a) for a in anc], _t(img_hw), _t(sf), test, num_classes=13)
    else:
        want = jax.jit(lambda o, h, s: janchor_loss.decode_detections_ssd(
            o, anc, h, s, test, num_classes=13))(
                jax.tree.map(jnp.asarray, outs), jnp.asarray(img_hw),
                jnp.asarray(sf))
        got = anchor_loss.decode_detections_ssd(
            [{k: _t(v) for k, v in o.items()} for o in outs],
            [_t(a) for a in anc], _t(img_hw), _t(sf), test, num_classes=13)
    assert np.asarray(want['valid']).sum() > 10
    for k in ('det_labels', 'valid', 'det_kpts'):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    assert got['det_kpts'].shape[-1] == 3
    np.testing.assert_allclose(_np(got['det_bboxes']),
                               np.asarray(want['det_bboxes']), rtol=1e-4,
                               atol=1e-4)


# ----------------------------------------------------------- whole models
def family_cfg(head_type):
    """R-50 (frozen_stages=1) with a 3-level FPN at 64 channels (strides
    8/16/32); RetinaHead with one GN tower conv a branch, or SSDHead."""
    return KGDetConfig(
        backbone=BackboneConfig(depth=50, frozen_stages=1),
        neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=64,
                        start_level=1, num_outs=3, add_extra_convs=True,
                        select_out=None, norm=None),
        head=HeadConfig(type=head_type, num_classes=13, in_channels=64,
                        feat_channels=64, stacked_convs=1, gn_groups=8,
                        octave_base_scale=4, scales_per_octave=2,
                        point_strides=STRIDES, ssd_anchor_ratios=SSD_RATIOS),
        assigner=AssignConfig(type='MaxIoUAssigner', pos_iou_thr=0.5,
                              neg_iou_thr=0.4, min_pos_iou=0.0),
        test=TestCfg(nms_pre=50, max_per_class=10, max_per_img=20,
                     score_thr=0.0),
        optim=OptimConfig(warmup_iters=2),
        val_data=DataConfig(img_scale=(96, 64), canvas_hw=(CANVAS,)),
    )


def _perturb(variables):
    """Random BN statistics (so folding is not the identity)."""
    rng = np.random.RandomState(0)

    def f(path, v):
        key = getattr(path[-1], 'key', str(path[-1]))
        v = np.asarray(v)
        if key == 'mean':
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        if key == 'var':
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(f, variables)


def _named(tree):
    return {k: v.numpy() for k, v in
            state_dict_from_jax({'params': tree}).items()}


@pytest.fixture(scope='module', params=['RetinaHead', 'SSDHead'])
def both(request):
    cfg = family_cfg(request.param)
    jmodel = jbuild_model(cfg)
    variables = _perturb(init_variables(jmodel, cfg, canvas_hw=CANVAS))
    params, stats = variables['params'], variables['batch_stats']
    batch = synth_batch(canvas=CANVAS, B=2, G=4, K=cfg.head.num_keypts)
    jbatch = jax.tree.map(jnp.asarray, batch)
    grids = jtrain.build_level_geometry(cfg, CANVAS)

    def loss_fn(p):
        outs = jmodel.apply({'params': p, 'batch_stats': stats},
                            jbatch['image'])
        valids = jtrain.batch_valid_flags(cfg, CANVAS, jbatch['valid_hw'])
        return jtrain.compute_loss(outs, grids, valids, jbatch, cfg,
                                   canvas_hw=CANVAS)
    (jtotal, jlogs), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = build_model(cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    total, logs = ttrain.make_loss_fn(model, cfg, CANVAS)(batch)
    total.backward()
    tgrads = {k: None if v.grad is None else v.grad.clone()
              for k, v in model.named_parameters()}
    model.zero_grad()
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, model=model,
                jlogs={k: float(v) for k, v in jlogs.items()},
                jtotal=float(jtotal), logs={k: v.item() for k, v in
                                            logs.items()},
                total=total.item(), jgrads=_named(jgrads), tgrads=tgrads)


def test_head_outputs_match_jax(both):
    """Every level's cls and bbox maps, f32, 1e-4 of each map's scale."""
    img = np.random.RandomState(3).randn(2, *CANVAS, 3).astype(np.float32)
    want = jax.jit(both['jmodel'].apply)(both['variables'], jnp.asarray(img))
    with torch.no_grad():
        got = both['model'](torch.from_numpy(img))
    assert len(got) == len(want) == 3
    for lvl, (g, w) in enumerate(zip(got, want)):
        for k in ('cls', 'bbox'):
            w_k = np.asarray(w[k])
            assert tuple(g[k].shape) == w_k.shape
            np.testing.assert_allclose(_np(g[k]), w_k, rtol=1e-4,
                                       atol=1e-4 * np.abs(w_k).max(),
                                       err_msg=f'{k} level {lvl}')


def test_model_loss_and_every_gradient_match_jax(both):
    """The loss terms (1e-4 relative) and every parameter's gradient (1e-4
    of its scale); the frozen prefix has none in the port and a zero one
    in JAX."""
    assert sorted(both['logs']) == sorted(both['jlogs']) == sorted(LOSS_KEYS)
    np.testing.assert_allclose(both['total'], both['jtotal'], rtol=1e-4)
    for k, v in both['jlogs'].items():
        np.testing.assert_allclose(both['logs'][k], v, rtol=1e-4, err_msg=k)
    checked = 0
    for name, want in both['jgrads'].items():
        got = both['tgrads'][name]
        if got is None:
            assert not want.any(), name
            continue
        np.testing.assert_allclose(_np(got), want, rtol=0, err_msg=name,
                                   atol=1e-4 * np.abs(want).max())
        checked += 1
    assert checked > 100


def test_predict_matches_jax(both):
    """make_predict_fn: labels and valid equal, boxes and scores within
    1e-3 (the head outputs' 1e-4 carried through the delta decode), the
    dummy keypoints zero and of width 3."""
    cfg = both['cfg']
    rng = np.random.RandomState(4)
    batch = {'image': rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8),
             'img_hw': np.asarray([[64, 96], [56, 80]], np.float32),
             'scale_factor': np.asarray([1.0, 0.75], np.float32)}
    want = jmake_predict_fn(both['jmodel'], cfg, CANVAS)(
        both['variables'], {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_predict_fn(both['model'].eval(), cfg, CANVAS)(batch)
    assert np.asarray(want['valid']).sum() > 0
    for k in ('valid', 'det_labels', 'det_kpts'):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(_np(got['det_bboxes']),
                               np.asarray(want['det_bboxes']), rtol=1e-3,
                               atol=1e-3)


def test_state_dict_round_trip(both):
    """port state_dict -> torch_convert -> flax leaves: nothing skipped,
    every leaf present and back as it was."""
    params, stats, skipped = convert_state_dict(both['model'].state_dict())
    assert skipped == []
    merged = merge_into_variables(both['variables'], params, stats,
                                  strict=True)
    flat = jax.tree_util.tree_flatten_with_path
    assert len(flat(params)[0]) + len(flat(stats)[0]) == \
        len(flat(both['variables'])[0])
    for (pa, a), (pb, b) in zip(flat(merged)[0],
                                flat(both['variables'])[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_trainer_steps_and_frozen_prefix(both):
    """init_trainer on the family: finite logs, a frozen parameter
    unchanged, the head's output conv moved."""
    cfg = both['cfg']
    model, _, step = init_trainer(cfg, CANVAS, 10, device='cpu')
    free = 'bbox_head.retina_cls.weight' if cfg.head.type == 'RetinaHead' \
        else 'bbox_head.cls_convs.0.weight'
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone()
              for n in (free, 'backbone.layer1.0.conv1.weight')}
    logs = step(synth_batch(canvas=CANVAS, B=2, G=4, K=cfg.head.num_keypts))
    assert all(torch.isfinite(v) for v in logs.values())
    assert torch.equal(params['backbone.layer1.0.conv1.weight'],
                       before['backbone.layer1.0.conv1.weight'])
    assert not torch.equal(params[free], before[free])


# ------------------------------------------------------------------ SSD300
@pytest.fixture(scope='module')
def ssd300():
    jcfg, cfg = jload_config(SSD300), load_config(SSD300)
    jmodel = jbuild_model(jcfg.replace(compute_dtype='float32'))
    variables = init_variables(jmodel, jcfg, canvas_hw=(300, 300))
    model = build_model(cfg.replace(compute_dtype='float32'), device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jcfg, cfg, jmodel, variables, model.eval()


def test_ssd300_levels_match_jax(ssd300):
    """configs/ssd300_vgg16_deepfashion2.py as shipped (the VGG-16 trunk
    with the Identity neck; its widths are fixed and its extras need the
    300 input), batch 1 at 300x300, f32: all six levels' cls and bbox maps
    within 1e-4 of each map's scale."""
    _, cfg, jmodel, variables, model = ssd300
    img = np.random.RandomState(5).randn(1, 300, 300, 3).astype(np.float32)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    sizes = [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)]
    assert len(got) == len(want) == 6
    for lvl, (g, w) in enumerate(zip(got, want)):
        for k in ('cls', 'bbox'):
            w_k = np.asarray(w[k])
            assert tuple(g[k].shape[2:4]) == sizes[lvl]
            np.testing.assert_allclose(_np(g[k]), w_k, rtol=1e-4,
                                       atol=1e-4 * np.abs(w_k).max(),
                                       err_msg=f'{k} level {lvl}')


def test_ssd300_round_trip_and_pth_routes(ssd300):
    """The SSD300 state_dict through torch_convert with zero skipped keys;
    load_reference_state takes the reference names (features.<i>,
    extra.<i>, l2_norm.weight, the per-level cls_convs / reg_convs) and
    refuses, as the JAX route does, a RetinaHead key, a shape that differs
    and a ResNet key."""
    jcfg, _, _, variables, model = ssd300
    state = model.state_dict()
    params, stats, skipped = convert_state_dict(state)
    assert skipped == []
    merge_into_variables(variables, params, stats, strict=True)
    for key in ('backbone.features.31.weight', 'backbone.extra.7.bias',
                'backbone.l2_norm.weight', 'bbox_head.cls_convs.5.weight'):
        assert key in state
    fresh = build_model(load_config(SSD300), device='cpu').init_weights(3)
    extra = {'module.backbone.fc.weight': torch.zeros(3)}
    skipped = load_reference_state(
        fresh, {**{k: v.clone() for k, v in state.items()},
                **{k[len('module.'):]: v for k, v in extra.items()}})
    assert skipped == ['backbone.fc.weight']
    for k, v in state.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    refused = [
        ({'bbox_head.retina_cls.weight': torch.zeros(9, 64, 3, 3)},
         KeyError),
        ({'backbone.layer1.0.conv1.weight': torch.zeros(64, 64, 1, 1)},
         KeyError),
        ({'backbone.features.0.weight': torch.zeros(64, 3, 5, 5)},
         ValueError),
    ]
    for bad, err in refused:
        with pytest.raises(err):
            load_reference_state(fresh, bad)
        params, stats, _ = convert_state_dict(bad)
        with pytest.raises(err):
            merge_into_variables(variables, params, stats, strict=True)


def test_retina_pth_routes(both):
    """A RetinaHead / SSDHead state loads through load_reference_state with
    nothing skipped; keys of the other anchor head are refused, as
    merge_into_variables(strict=True) refuses them."""
    model, variables = both['model'], both['variables']
    state = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = build_model(both['cfg'], device='cpu')
    assert load_reference_state(fresh, state) == []
    for k, v in state.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    other = {'bbox_head.cls_convs.0.weight': torch.zeros(56, 64, 3, 3)} \
        if both['cfg'].head.type == 'RetinaHead' \
        else {'bbox_head.retina_reg.weight': torch.zeros(24, 64, 3, 3),
              'bbox_head.cls_convs.0.conv.weight': torch.zeros(64, 64, 3, 3)}
    for key, value in other.items():
        with pytest.raises(KeyError):
            load_reference_state(fresh, {key: value})
        params, stats, _ = convert_state_dict({key: value})
        with pytest.raises(KeyError):
            merge_into_variables(variables, params, stats, strict=True)


# -------------------------------------------- evaluation of dummy keypoints
def test_width3_keypoints_scored_as_jax(both, tmp_path):
    """The anchor decodes' width-3 dummy keypoints: the port's evaluation
    (JSON files and AP stats, bbox and keypoints) equals the JAX
    package's on the same detections, over a synthetic PNG set."""
    pytest.importorskip('cv2')
    from kgdet_tpu import eval_loop as jeval_loop
    from kgdet_tpu.data.dataset import DeepFashion2Dataset as JDataset
    from kgdet_tpu_torch import eval_loop as teval_loop
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.data.loader import DataLoader
    from tests.test_torch_eval import make_eval_set
    d = str(tmp_path)
    ann = make_eval_set(d, n_images=6, landscape_only=True)
    data = DataConfig(ann_file=ann, img_prefix=d, img_scale=(96, 64),
                      max_gts=8, batch_size=3, flip_ratio=0.0,
                      canvas_hw=(CANVAS,))
    tcfg = both['cfg'].replace(val_data=data)
    tds = DeepFashion2Dataset(tcfg.val_data, train=False)
    results = teval_loop.run_inference(
        both['model'].eval(), tcfg, DataLoader(tds, 3, train=False,
                                               num_workers=0), verbose=False)
    assert all(r[2].shape[1] == 3 for r in results.values())
    assert sum(len(r[0]) for r in results.values()) > 0
    t_stats, t_files = teval_loop.evaluate_results(
        results, tds, str(tmp_path / 't'), verbose=False)
    j_stats, j_files = jeval_loop.evaluate_results(
        results, JDataset(data, train=False), str(tmp_path / 'j'),
        verbose=False)
    assert t_stats == j_stats
    for k in t_files:
        with open(t_files[k], 'rb') as a, open(j_files[k], 'rb') as b:
            assert a.read() == b.read(), k


# ------------------------------------------------------- tools/benchmark.py
BENCH_CONFIG = '''
from kgdet_tpu.config import (AssignConfig, BackboneConfig, DataConfig,
                              HeadConfig, KGDetConfig, NeckConfig,
                              TestConfig)
config = KGDetConfig(
    backbone=BackboneConfig(depth=50, frozen_stages=1),
    neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=32,
                    start_level=1, num_outs=3, add_extra_convs=True,
                    select_out=None, norm=None),
    head=HeadConfig(type='RetinaHead', num_classes=13, in_channels=32,
                    feat_channels=32, stacked_convs=1, norm=None,
                    point_strides=(8, 16, 32)),
    test=TestConfig(nms_pre=50, max_per_class=10, max_per_img=20),
    val_data=DataConfig(img_scale=(96, 64), canvas_hw=((64, 96),)))
'''


def test_benchmark_cli_synthetic_on_the_cpu(tmp_path):
    """tools/benchmark.py --synthetic --device cpu on a tiny RetinaNet
    config, in a process where jax, flax, cv2 and kgdet_tpu cannot be
    imported: exits 0 and prints its 'Overall fps' line for the iterations
    asked for; main() returns the same numbers."""
    path = tmp_path / 'cfg.py'
    path.write_text(BENCH_CONFIG)
    code = '\n'.join([
        'import sys',
        "for m in ('jax', 'flax', 'cv2', 'kgdet_tpu'):",
        '    sys.modules[m] = None',
        'import torch',
        'torch.set_num_threads(1)',
        'from kgdet_tpu_torch.tools import benchmark',
        f"out = benchmark.main([{str(path)!r}, '--synthetic', '--device', "
        "'cpu', '--num-images', '4', '--warmup', '1', '--batch-size', '2'])",
        "assert out['iters'] == 2 and out['fps'] > 0, out",
        "assert out['canvas'] == (64, 96) and out['device'] == 'cpu'",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith('Overall fps: ')]
    assert len(lines) == 1 and 'batch 2, canvas (64, 96), cpu' in lines[0]
    res = subprocess.run(
        [sys.executable, '-m', 'kgdet_tpu_torch.tools.benchmark', str(path),
         '--synthetic', '--num-images', '2'], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    if not torch.cuda.is_available():      # the default device is the card
        assert res.returncode != 0 and 'CUDA' in res.stderr


# ----------------------------------------------------- the CLIs on the CPU
CLI_CONFIG = '''
from kgdet_tpu.config import (AssignConfig, BackboneConfig, DataConfig,
                              HeadConfig, KGDetConfig, NeckConfig,
                              OptimConfig, TestConfig)
_DATA = dict(ann_file={ann!r}, img_prefix={prefix!r}, img_scale=(96, 64),
             max_gts=8, batch_size=2, canvas_hw=((64, 96),))
config = KGDetConfig(
    backbone=BackboneConfig(depth=50, frozen_stages=1),
    neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=32,
                    start_level=1, num_outs=3, add_extra_convs=True,
                    select_out=None, norm=None),
    head=HeadConfig(type='SSDHead', num_classes=13,
                    point_strides=(8, 16, 32),
                    ssd_anchor_ratios=((2,), (2, 3), (2,))),
    assigner=AssignConfig(pos_iou_thr=0.5, neg_iou_thr=0.5,
                          min_pos_iou=0.2),
    test=TestConfig(nms_pre=50, max_per_class=10, max_per_img=20,
                    score_thr=0.0),
    optim=OptimConfig(warmup_iters=2),
    train_data=DataConfig(flip_ratio=0.5, photo_metric_distortion=True,
                          expand=True, random_crop=True, **_DATA),
    val_data=DataConfig(flip_ratio=0.0, **_DATA))
'''


def test_train_and_test_clis_take_an_anchor_config(tmp_path, capsys):
    """tools/train.py --validate on an SSD head (with the SSD recipe's
    photometric distortion, expand and min-IoU crop) for one epoch of 3
    steps on 6 PNGs, then tools/test.py --checkpoint on the last step:
    finite records, one checkpoint, the copypaste lines, and the CLI's
    detections equal to the runner model's."""
    pytest.importorskip('cv2')
    from kgdet_tpu_torch.tools import test as ttest
    from kgdet_tpu_torch.tools import train as ttrain_cli
    from tests.test_torch_eval import make_eval_set
    d = str(tmp_path)
    ann = make_eval_set(d, n_images=6, landscape_only=True)
    path = tmp_path / 'cfg.py'
    path.write_text(CLI_CONFIG.format(ann=ann, prefix=d))
    work = str(tmp_path / 'work')
    runner = ttrain_cli.main([str(path), '--work-dir', work, '--device',
                              'cpu', '--max-epochs', '1', '--validate',
                              '--log-interval', '1'])
    printed = capsys.readouterr().out
    assert runner.step == 3
    assert os.listdir(os.path.join(work, 'checkpoints')) == ['3']
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    assert [r['mode'] for r in recs] == ['train'] * 3 + ['val']
    assert all(np.isfinite(v) for r in recs for v in r.values()
               if not isinstance(v, str))
    assert 'bbox_mAP_copypaste: ' in printed
    out = ttest.main([str(path), '--device', 'cpu', '--checkpoint',
                      os.path.join(work, 'checkpoints', '3'),
                      '--json-out', str(tmp_path / 'res')])
    printed = capsys.readouterr().out
    assert 'bbox_mAP_copypaste: ' in printed
    assert 'keypoints_mAP_copypaste: ' in printed
    from kgdet_tpu_torch.eval_loop import run_inference
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.data.loader import DataLoader
    cfg = load_config(str(path))
    want = run_inference(runner.model.eval(), cfg, DataLoader(
        DeepFashion2Dataset(cfg.val_data, train=False), 2, train=False,
        num_workers=0), verbose=False)
    assert sorted(out['results']) == sorted(want)
    for i, (boxes, labels, kpts) in want.items():
        got = out['results'][i]
        np.testing.assert_array_equal(got[1], labels)
        np.testing.assert_array_equal(got[0], boxes)
        assert got[2].shape == kpts.shape and kpts.shape[1] == 3
