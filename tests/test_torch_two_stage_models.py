"""The box-only two-stage detectors in the port (kgdet_tpu_torch:
models/two_stage.py through api.py, parallel/train.py, eval_loop.py,
tools/test.py, tools/benchmark.py, utils/convert.py) against kgdet_tpu on
the CPU, tiny sizes as tests/test_two_stage.py has them (ResNet-18, a
3-level FPN of 64 channels, 64 proposals; the C4 recipe on ResNet-18's
first three stages with 16 proposals).

For each detector class (RPN; Faster R-CNN with the ConvFC head, with the
C4 shared layer4 and with the double head; Fast R-CNN; Cascade R-CNN),
with the JAX package's weights through state_dict_from_jax: the served
forward (proposals in the same order within an ulp of the decode's exp,
RoI head outputs within 1e-4 of scale), the training loss on JAX's sampler
uniforms (every term within 1e-4 relative) and every parameter's gradient
by the whole-model rule of ROADMAP "Standing findings", make_predict_fn's
detections (labels and valid equal, boxes within 5e-4), the state-dict
round trip through the JAX converter with nothing skipped, the .pth route
and converter_skips key by key against the JAX converter's skip list, one
trainer step; then tools/test.py on RPN (AR@N) and on Faster R-CNN (bbox
mAP) over make_synth_coco against the JAX package's CLI on the same .pth,
and tools/benchmark.py --synthetic on both.
"""
import contextlib
import dataclasses
import io
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.api import make_predict_fn as jmake_predict_fn
from kgdet_tpu.config import BackboneConfig, DataConfig, NeckConfig
from kgdet_tpu.core.two_stage_loss import two_stage_loss_fn as jloss_fn
from kgdet_tpu.ops.anchors import anchor_valid_flags as janchor_valid_flags
from kgdet_tpu.tools import test as jtest_cli
from kgdet_tpu.utils.torch_convert import (convert_state_dict,
                                           merge_into_variables)
from kgdet_tpu_torch.api import build_model, init_trainer, make_predict_fn
from kgdet_tpu_torch.core import two_stage_loss as tsl
from kgdet_tpu_torch.models import two_stage as ts
from kgdet_tpu_torch.parallel import train as ttrain
from kgdet_tpu_torch.tools import benchmark as tbenchmark
from kgdet_tpu_torch.tools import test as ttest_cli
from kgdet_tpu_torch.utils.convert import (converter_skips,
                                           load_reference_state,
                                           state_dict_from_jax)
from tests.common import synth_batch
from tests.test_data import make_synth_coco
from tests.test_torch_dist import write_port_config
from tests.test_torch_two_stage import jax_uniforms
from tests.test_two_stage import frcnn_cfg

torch.set_num_threads(1)
CANVAS = (64, 96)
SEED = 5
MODEL_F32_REL, MODEL_GRAD_REL, MODEL_FLIP_SHARE = 1e-3, 5e-2, 1e-2


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close_scaled(got, want, rel, err_msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=rel, err_msg=err_msg,
                               atol=rel * max(np.abs(want).max(), 1e-12))


def kind_cfg(kind):
    cfg = frcnn_cfg()
    if kind == 'rpn':
        return cfg.replace(detector_type='rpn')
    if kind == 'double_head':
        return cfg.replace(detector_type='double_head_rcnn')
    if kind == 'fast':
        return cfg.replace(detector_type='fast_rcnn')
    if kind == 'cascade':
        return cfg.replace(detector_type='cascade_rcnn')
    if kind == 'c4':
        # the C4 recipe on ResNet-18's first three stages: the stride-16
        # map, the shared layer4 (bottlenecks of planes 512, caffe style)
        return cfg.replace(
            rcnn_head='res_layer',
            backbone=BackboneConfig(depth=18, num_stages=3,
                                    out_indices=(2,), style='caffe'),
            neck=NeckConfig(type='Identity', out_channels=256),
            head=dataclasses.replace(cfg.head, point_strides=(16,)),
            num_proposals_train=16, num_proposals_test=16)
    return cfg


KINDS = ('rpn', 'convfc', 'c4', 'double_head', 'fast', 'cascade')
FREE = {'rpn': 'rpn_head.rpn_cls.weight',
        'cascade': 'bbox_head.2.fc_cls.weight'}
# the gradients held to MODEL_F32_REL in every element: no ReLU network
# lies between them and the loss but the fc layers' own
STRICT = re.compile(r'rpn_head\.|bbox_head\.(\d+\.)?(shared_fcs|fc_cls|fc_reg'
                    r'|fc_branch)\.')


def _perturb(variables):
    """Random BatchNorm statistics: folding is then not the identity."""
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


def _batch(cfg, seed=0):
    batch = synth_batch(canvas=CANVAS, B=2, G=4, K=cfg.head.num_keypts,
                        seed=seed)
    if cfg.detector_type == 'fast_rcnn':
        rng = np.random.RandomState(seed + 1)
        gts = np.repeat(batch['gt_bboxes'], 6, axis=1)
        jitter = rng.randn(*gts.shape).astype(np.float32) * 3
        batch['proposals'] = np.concatenate(
            [gts + jitter, gts[:, :16] * 0.7], 1).astype(np.float32)
        batch['proposals_valid'] = rng.rand(2, 40) > 0.1
    return batch


def _jax_draw(detector_type, key, sampler):
    """draw(role, n) of the port returning the uniforms that the JAX loss
    of ``detector_type`` draws from ``key`` for that role."""
    if detector_type == 'rpn':
        roles = {tsl.RPN_ROLE: key}
    elif detector_type == 'fast_rcnn':
        roles = {tsl.rcnn_role(0): key}
    elif detector_type == 'cascade_rcnn':
        keys = jax.random.split(key, 4)
        roles = {tsl.RPN_ROLE: keys[0],
                 **{tsl.rcnn_role(i): keys[1 + i] for i in range(3)}}
    else:
        k1, k2 = jax.random.split(key)
        roles = {tsl.RPN_ROLE: k1, tsl.rcnn_role(0): k2}

    def draw(role, n):
        rcnn = role != tsl.RPN_ROLE
        return torch.from_numpy(jax_uniforms(
            roles[role], 2, n,
            pos_balanced=rcnn and sampler == 'instance_balanced',
            neg_balanced=rcnn and sampler == 'iou_balanced'))
    return draw


def _jax_loss_and_grads(jmodel, cfg, variables, batch):
    """The JAX train step's two-stage loss (parallel/train.py) and its
    gradients, on PRNGKey(SEED)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    A = len(cfg.head.anchor_scales) * len(cfg.head.anchor_ratios)
    valids = []
    for s in cfg.head.point_strides:
        fh, fw = -(-CANVAS[0] // s), -(-CANVAS[1] // s)
        vh = jnp.ceil(jb['valid_hw'][:, 0] / s).astype(jnp.int32)
        vw = jnp.ceil(jb['valid_hw'][:, 1] / s).astype(jnp.int32)
        valids.append(jax.vmap(
            lambda a, b: janchor_valid_flags(fh, fw, A, a, b))(vh, vw))
    kw = {k: jb[k] for k in ('proposals', 'proposals_valid') if k in jb}

    def loss(p):
        fwd = jmodel.apply({'params': p,
                            'batch_stats': variables['batch_stats']},
                           jb['image'], jb['valid_hw'].astype(jnp.float32),
                           train=True, **kw)
        return jloss_fn(cfg.detector_type)(fwd, jb, jax.random.PRNGKey(SEED),
                                           cfg, valids, canvas_hw=CANVAS)
    (total, logs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables['params'])
    return float(total), {k: float(v) for k, v in logs.items()}, \
        {k: v.numpy() for k, v in
         state_dict_from_jax({'params': grads}).items()}


def _jax_variables(jmodel, cfg):
    """init_variables, or for Fast R-CNN the same init fed proposals."""
    if cfg.detector_type != 'fast_rcnn':
        return _perturb(init_variables(jmodel, cfg, canvas_hw=CANVAS))
    x = jnp.zeros((1, *CANVAS, 3), jnp.float32)
    props = jnp.asarray([[[4., 4., 40., 40.]]])
    return _perturb(dict(jax.jit(lambda r: jmodel.init(
        r, x, proposals=props))(jax.random.PRNGKey(cfg.seed))))


@pytest.fixture(scope='module', params=KINDS)
def both(request):
    cfg = kind_cfg(request.param)
    jmodel = jbuild_model(cfg)
    variables = _jax_variables(jmodel, cfg)
    model = build_model(cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    batch = _batch(cfg)
    jtotal, jlogs, jgrads = _jax_loss_and_grads(jmodel, cfg, variables,
                                                batch)
    real = tsl.sampler_draw
    try:
        tsl.sampler_draw = lambda seed, B, dev: _jax_draw(
            cfg.detector_type, jax.random.PRNGKey(seed), cfg.rcnn_sampler)
        total, logs = ttrain.make_loss_fn(model, cfg, CANVAS)(
            dict(batch, seed=np.int32(SEED)))
    finally:
        tsl.sampler_draw = real
    total.backward()
    tgrads = {k: None if v.grad is None else v.grad.clone()
              for k, v in model.named_parameters()}
    model.zero_grad()
    return dict(kind=request.param, cfg=cfg, jmodel=jmodel,
                variables=variables, model=model, batch=batch,
                jtotal=jtotal, jlogs=jlogs, jgrads=jgrads,
                total=total.item(), logs={k: v.item() for k, v in
                                          logs.items()}, tgrads=tgrads)


def _served(both):
    img = np.random.RandomState(3).randn(2, *CANVAS, 3).astype(np.float32)
    img_hw = np.asarray([[60., 90.], [64., 96.]], np.float32)
    kw = {k: both['batch'][k] for k in ('proposals', 'proposals_valid')
          if k in both['batch']}
    want = jax.jit(lambda v, x, hw, **k: both['jmodel'].apply(
        v, x, hw, train=False, **k))(
        both['variables'], jnp.asarray(img), jnp.asarray(img_hw),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = both['model'](torch.from_numpy(img), torch.from_numpy(img_hw),
                            train=False, **{k: torch.from_numpy(v)
                                            for k, v in kw.items()})
    return got, want


def test_served_forward_matches_jax(both):
    """train=False: the proposals in the same order (valid and scores
    equal, boxes within an ulp of the decode's exp), each stage's class
    logits and deltas within 1e-4 of scale."""
    got, want = _served(both)
    np.testing.assert_array_equal(_np(got['proposal_valid']),
                                  np.asarray(want['proposal_valid']))
    np.testing.assert_allclose(_np(got['proposal_scores']),
                               np.asarray(want['proposal_scores']),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(got['proposals']),
                               np.asarray(want['proposals']), rtol=1e-6,
                               atol=1e-4)
    assert _np(got['proposal_valid']).sum() > 10
    stages = list(zip(got['stages'], want['stages'])) if 'stages' in want \
        else [(got, want)] if 'roi_cls' in want else []
    assert len(stages) == (3 if both['kind'] == 'cascade' else
                           0 if both['kind'] == 'rpn' else 1)
    for i, (g, w) in enumerate(stages):
        for k in ('roi_cls', 'roi_reg'):
            assert tuple(g[k].shape) == np.asarray(w[k]).shape
            _close_scaled(g[k], w[k], 1e-4, f'stage {i} {k}')


def test_loss_and_every_gradient_match_jax(both):
    """On the JAX loss's own sampler uniforms: every term within 1e-4
    relative, every parameter's gradient by the whole-model rule
    (MODEL_GRAD_REL of its scale in every element, MODEL_F32_REL in all
    but MODEL_FLIP_SHARE of them), the RPN head's and the box heads' fc
    layers within MODEL_F32_REL in every element (the double head's conv
    branch is a ReLU network as the backbone is, and takes the whole-model
    rule); the frozen stem and layer1 have none in the port and a zero one
    in JAX."""
    assert sorted(both['logs']) == sorted(both['jlogs'])
    np.testing.assert_allclose(both['total'], both['jtotal'], rtol=1e-4)
    for k, v in both['jlogs'].items():
        np.testing.assert_allclose(both['logs'][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    beyond = total = checked = 0
    for name, want in both['jgrads'].items():
        got = both['tgrads'][name]
        if got is None or not want.any():
            assert got is None or not got.any(), name
            assert not want.any() or name.startswith(
                ('backbone.conv1', 'backbone.bn1', 'backbone.layer1.')), name
            continue
        diff = np.abs(_np(got) - want) / np.abs(want).max()
        assert diff.max() <= MODEL_GRAD_REL, (name, diff.max())
        if STRICT.match(name):
            assert diff.max() <= MODEL_F32_REL, (name, diff.max())
        beyond += int((diff > MODEL_F32_REL).sum())
        total += diff.size
        checked += 1
    assert beyond <= MODEL_FLIP_SHARE * total, beyond / total
    assert checked > 20


def test_predict_matches_jax(both):
    """make_predict_fn: labels and valid equal, boxes and scores within
    5e-4, width-3 zero keypoints (RPN: its ranked proposals)."""
    cfg = both['cfg']
    rng = np.random.RandomState(4)
    batch = {'image': rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8),
             'img_hw': np.asarray([[64, 96], [56, 80]], np.float32),
             'scale_factor': np.asarray([1.0, 0.75], np.float32)}
    batch.update({k: both['batch'][k] for k in ('proposals',
                                                 'proposals_valid')
                  if k in both['batch']})
    want = jmake_predict_fn(both['jmodel'], cfg, CANVAS)(
        both['variables'], {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_predict_fn(both['model'].eval(), cfg, CANVAS)(batch)
    both['model'].train()
    assert np.asarray(want['valid']).sum() > 0
    for k in ('valid', 'det_labels'):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), k)
    assert _np(got['det_kpts']).shape[-1] == 3
    np.testing.assert_allclose(_np(got['det_bboxes']),
                               np.asarray(want['det_bboxes']), rtol=5e-4,
                               atol=5e-4)


# keys the JAX converter maps or skips, beside the model's own, with a
# shape its layout maps take: the skip rule of converter_skips held against
# convert_state_dict key by key
EXTRA_KEYS = {
    'rpn': {'rpn_head.rpn_conv.extra': (3,),
            'rpn_head.conv_loc.weight': (1, 1, 1, 1),
            'rpn_head.foo.weight': (3,)},
    'convfc': {'bbox_head.shared_fcs.0.bias': (3,),
               'bbox_head.fc_cls.bias': (3,),
               'bbox_head.other.weight': (3,)},
    'c4': {'shared_head.layer4.0.conv9.weight': (1, 1, 1, 1),
           'shared_head.layer4.0.downsample.1.weight': (3,),
           'shared_head.layer4.0.relu.weight': (3,),
           'shared_head.extra.weight': (3,)},
    'double_head': {'bbox_head.conv_branch.0.gn2.bias': (3,),
                    'bbox_head.conv_branch.0.relu.weight': (3,),
                    'bbox_head.fc_branch.1.bias': (3,),
                    'bbox_head.res_block.conv1.gn.bias': (3,)},
    'fast': {'roi_extractor.x.weight': (3,)},
    'cascade': {'bbox_head.1.fc_reg.bias': (3,),
                'bbox_head.0.shared_fcs.1.weight': (3, 3),
                'bbox_head.2.other.weight': (3,)},
}


def test_round_trip_pth_route_and_skips_match_jax(both):
    """The port's state_dict through the JAX converter: nothing skipped,
    every leaf back as it was (shared_fcs.0 in its (C, roi, roi) order);
    load_reference_state takes it; converter_skips decides every key of the
    model and of EXTRA_KEYS as the JAX converter does."""
    model, variables = both['model'], both['variables']
    state = model.state_dict()
    params, stats, skipped = convert_state_dict(dict(state))
    assert skipped == []
    merged = merge_into_variables(variables, params, stats, strict=True)
    flat = jax.tree_util.tree_flatten_with_path
    assert len(flat(params)[0]) + len(flat(stats)[0]) == \
        len(flat(variables)[0])
    for (pa, a), (pb, b) in zip(flat(merged)[0], flat(variables)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert load_reference_state(model, dict(state)) == []
    extra = {k: torch.zeros(shape)
             for k, shape in EXTRA_KEYS[both['kind']].items()}
    _, _, jskipped = convert_state_dict({**state, **extra})
    for k in list(state) + list(extra):
        assert converter_skips(k) == (k in jskipped), k
    assert jskipped


def test_trainer_steps_and_frozen_prefix(both):
    """init_trainer: finite logs, a frozen parameter unchanged, a head's
    weight moved."""
    cfg = both['cfg']
    model, _, step = init_trainer(cfg, CANVAS, 10, device='cpu')
    free = FREE.get(both['kind'], 'bbox_head.fc_cls.weight')
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone()
              for n in (free, 'backbone.layer1.0.conv1.weight')}
    logs = step(dict(_batch(cfg, seed=2), seed=np.int32(3)))
    assert all(torch.isfinite(v) for v in logs.values())
    assert torch.equal(params['backbone.layer1.0.conv1.weight'],
                       before['backbone.layer1.0.conv1.weight'])
    assert not torch.equal(params[free], before[free])


# ------------------------------------------------------------------ the CLIs
def _numbers(printed, prefix):
    line = next(ln for ln in printed.splitlines() if ln.startswith(prefix))
    return [float(x) for x in line.split(':', 1)[1].split()]


@pytest.mark.parametrize('kind', ['rpn', 'convfc'])
def test_test_cli_matches_jax_cli(kind, tmp_path, monkeypatch):
    """tools/test.py of both packages on make_synth_coco with the same
    .pth (JAX-initialized weights): RPN's proposal_AR_copypaste and Faster
    R-CNN's bbox_mAP_copypaste numbers within 1e-3."""
    d = str(tmp_path)
    ann = make_synth_coco(d, n_images=6)
    cfg = kind_cfg(kind).replace(val_data=DataConfig(
        ann_file=ann, img_prefix=d, img_scale=(96, 64), batch_size=2,
        canvas_hw=((64, 96), (96, 64))))
    path = write_port_config(os.path.join(d, 'cfg.py'), cfg)
    variables = _jax_variables(jbuild_model(cfg), cfg)
    pth = os.path.join(d, 'w.pth')
    torch.save({'state_dict': state_dict_from_jax(variables)}, pth)
    prefix = 'proposal_AR_copypaste:' if kind == 'rpn' \
        else 'bbox_mAP_copypaste:'
    args = [path, '--load-pth', pth, '--json-out', os.path.join(d, 'out')]
    out = io.StringIO()
    monkeypatch.setattr(sys, 'argv', ['test.py', *args[:3], '--json-out',
                                      os.path.join(d, 'jout')])
    with contextlib.redirect_stdout(out):
        got = ttest_cli.main(args + ['--device', 'cpu'])
        jtest_cli.main()
    printed = out.getvalue()
    ports = [ln for ln in printed.splitlines() if ln.startswith(prefix)]
    assert len(ports) == 2, printed[-2000:]
    np.testing.assert_allclose(_numbers(ports[0], prefix),
                               _numbers(ports[1], prefix), atol=1e-3)
    assert len(got['results']) == 6


def test_benchmark_cli_runs_two_stage_configs(tmp_path):
    """tools/benchmark.py --synthetic on the CPU through make_predict_fn:
    Faster R-CNN and Fast R-CNN (synthetic proposals) report a rate."""
    for kind in ('convfc', 'fast'):
        cfg = kind_cfg(kind).replace(val_data=DataConfig(
            img_scale=(96, 64), canvas_hw=(CANVAS,), num_proposals=32))
        path = write_port_config(str(tmp_path / f'{kind}.py'), cfg)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = tbenchmark.main([path, '--synthetic', '--device', 'cpu',
                                   '--num-images', '2', '--warmup', '1',
                                   '--batch-size', '2'])
        assert res['fps'] > 0 and re.search(r'Overall fps: [\d.]+',
                                            out.getvalue())


def test_detector_classes_and_names():
    """The classes of each kind and the reference's module names."""
    for kind in KINDS:
        model = build_model(kind_cfg(kind), device='cpu')
        names = dict(model.named_parameters())
        if kind == 'double_head':
            assert isinstance(model.bbox_head, ts.DoubleConvFCBBoxHead)
            assert names['bbox_head.res_block.conv_identity.conv.bias'] \
                .shape == (1024,)
            assert names['bbox_head.fc_branch.0.weight'].shape == \
                (1024, 64 * 49)
        elif kind == 'c4':
            assert isinstance(model.shared_head, ts.SharedResLayer)
            assert names['shared_head.layer4.0.conv1.weight'].shape == \
                (512, 256, 1, 1)
        elif kind == 'fast':
            assert model.external_proposals and not any(
                n.startswith('rpn_head') for n in names)


def test_hrnet_levels_train_where_the_jax_package_raises():
    """HRFPN pools its levels with floor division: at 128x160 its stride-64
    level is 2x2 where ceil(canvas / 64) is 2x3. The port's RPN takes the
    anchor valid flags of the levels as made and trains; the JAX train
    step builds the flags from ceil and raises (ROADMAP Queue 3)."""
    from kgdet_tpu.parallel.train import make_optimizer, make_train_step
    canvas = (128, 160)
    cfg = frcnn_cfg().replace(
        backbone=BackboneConfig(type='HRNet', hrnet_width=8,
                                frozen_stages=-1),
        neck=NeckConfig(type='HRFPN', in_channels=(8, 16, 32, 64),
                        out_channels=32, num_outs=5, select_out=None),
        head=dataclasses.replace(frcnn_cfg().head,
                                 point_strides=(4, 8, 16, 32, 64)),
        num_proposals_train=16, num_proposals_test=16)
    batch = synth_batch(canvas=canvas, B=2, G=4, K=cfg.head.num_keypts)
    model, _, step = init_trainer(cfg, canvas, 10, device='cpu')
    logs = step(dict(batch, seed=np.int32(1)))
    assert all(torch.isfinite(v) for v in logs.values())
    # the JAX side abstractly: the step raises while it is traced, so
    # shapes are all it needs (no initialization run, no compile)
    jmodel = jbuild_model(cfg)
    variables = jax.eval_shape(
        lambda: init_variables(jmodel, cfg, canvas_hw=canvas))
    tx, _ = make_optimizer(cfg, variables['params'], 10)
    with pytest.raises(ValueError, match='Incompatible shapes'):
        jax.eval_shape(
            make_train_step(jmodel, cfg, canvas, tx), variables['params'],
            variables['batch_stats'],
            jax.eval_shape(tx.init, variables['params']),
            {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in batch.items()})
