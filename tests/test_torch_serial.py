"""The serial / parallel / plain RepPoints heads and the single-column
cascade of the port (kgdet_tpu_torch) against kgdet_tpu, whole.

One tiny model per head type (R-50 with frozen_stages=1 on a 64x96 canvas;
for the init/refine heads a 3-level GN FPN at 64 channels with strides
8/16/32, one tower conv, 6 keypoints, 9 RepPoints, a MaxIoU refine assigner
with a crowd-region threshold; for KGDetHead1Rep the one-level recipe of
tests/test_torch_model.py with one 9-tap column) is initialized by the JAX
package, its variables are carried into the port through
``state_dict_from_jax``, and both run the same inputs on the CPU in f32:
head outputs per level and stage, the loss terms by name, every parameter's
gradient, one optimizer step on shared gradients, the padded detections and
the state-dict round trip. Tolerances are stated at each assert.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.api import make_predict_fn as jmake_predict_fn
from kgdet_tpu.config import AssignConfig, BackboneConfig, DataConfig, \
    HeadConfig, KGDetConfig, NeckConfig, OptimConfig
from kgdet_tpu.config import TestConfig as TestCfg
from kgdet_tpu.parallel import train as jtrain
from kgdet_tpu.utils.torch_convert import (convert_state_dict,
                                           merge_into_variables)
from kgdet_tpu_torch.api import build_model, init_trainer, make_predict_fn
from kgdet_tpu_torch.parallel import train as ttrain
from kgdet_tpu_torch.utils.convert import state_dict_from_jax
from tests.common import synth_batch
from tests.test_torch_model import tiny_r50_cfg

torch.set_num_threads(1)
CANVAS = (64, 96)
KPTS = 6
HEAD_TYPES = ('SerialKpHead', 'ParallelKpHead', 'RepPointsHead',
              'KGDetHead1Rep')
OPTIM = OptimConfig(bias_lr_mult=2.0, bias_decay_mult=0.0,
                    norm_decay_mult=0.5, warmup_iters=2)


def family_cfg(head_type):
    if head_type == 'KGDetHead1Rep':
        cfg = tiny_r50_cfg()
        return cfg.replace(optim=OPTIM, head=dataclasses.replace(
            cfg.head, type=head_type, num_reppts=9, num_keypts=KPTS))
    return KGDetConfig(
        backbone=BackboneConfig(depth=50, frozen_stages=1),
        neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=64,
                        start_level=1, num_outs=3, add_extra_convs=True,
                        select_out=None, norm='gn', gn_groups=8),
        head=HeadConfig(
            type=head_type, num_classes=13, in_channels=64, feat_channels=64,
            point_feat_channels=64, stacked_convs=1, num_keypts=KPTS,
            num_reppts=9, point_strides=(8, 16, 32), gn_groups=8,
            loss_cls_weights=(1.0,), loss_bbox_weights=(0.5, 1.0),
            loss_kpt_weights=(2.0, 4.0), smooth_l1_beta=0.11),
        assigner=AssignConfig(type='PointAssigner', scale=4, pos_num=1),
        refine_assigner=AssignConfig(type='MaxIoUAssigner',
                                     ignore_iof_thr=0.5),
        test=TestCfg(nms_pre=50, max_per_class=10, max_per_img=20,
                     score_thr=0.0),
        optim=OPTIM,
        val_data=DataConfig(img_scale=(96, 64), canvas_hw=(CANVAS,)),
    )


def _perturb(variables):
    """Random BN statistics (so folding is not the identity) and 30x the
    head's 1x1 output kernels (spread logits, offsets of a few pixels)."""
    rng = np.random.RandomState(0)

    def f(path, v):
        keys = [getattr(p, 'key', str(p)) for p in path]
        v = np.asarray(v)
        if keys[-1] == 'mean':
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        if keys[-1] == 'var':
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if keys[-1] == 'kernel' and keys[-2].endswith('_out'):
            return v * 30
        return v
    return jax.tree_util.tree_map_with_path(f, variables)


def _train_batch(K):
    """tests/common.py::synth_batch plus one crowd region an image (and a
    padded one), which the refine assigner of the init/refine heads reads."""
    batch = synth_batch(canvas=CANVAS, B=2, G=4, K=K)
    batch['gt_bboxes_ignore'] = np.asarray(
        [[[40, 8, 90, 40], [0, 0, 0, 0]], [[4, 30, 40, 60], [0, 0, 0, 0]]],
        np.float32)
    batch['gt_ignore_mask'] = np.asarray([[True, False], [True, False]])
    return batch


def _named(tree):
    return {k: v.numpy() for k, v in
            state_dict_from_jax({'params': tree}).items()}


@pytest.fixture(scope='module', params=HEAD_TYPES)
def both(request):
    cfg = family_cfg(request.param)
    jmodel = jbuild_model(cfg)
    variables = _perturb(init_variables(jmodel, cfg, canvas_hw=CANVAS))
    params, stats = variables['params'], variables['batch_stats']
    batch = _train_batch(cfg.head.num_keypts)
    jbatch = jax.tree.map(jnp.asarray, batch)
    grids = jtrain.build_level_geometry(cfg, CANVAS)

    def loss_fn(p):
        outs = jmodel.apply({'params': p, 'batch_stats': stats},
                            jbatch['image'])
        valids = jtrain.batch_valid_flags(cfg, CANVAS, jbatch['valid_hw'])
        total, logs = jtrain.compute_loss(outs, grids, valids, jbatch, cfg,
                                          canvas_hw=CANVAS)
        return total, (logs, outs)

    (jtotal, (jlogs, jouts)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = build_model(cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        touts = model(torch.from_numpy(batch['image']))
    total, tlogs = ttrain.make_loss_fn(model, cfg, CANVAS)(batch)
    total.backward()
    return dict(head=request.param, cfg=cfg, jmodel=jmodel,
                variables=variables, model=model, jouts=jouts, touts=touts,
                jlogs={k: float(v) for k, v in jlogs.items()},
                tlogs={k: v.item() for k, v in tlogs.items()},
                jtotal=float(jtotal), ttotal=total.item(), jgrads=jgrads,
                tgrads={k: None if v.grad is None else v.grad.clone()
                        for k, v in model.named_parameters()})


def test_head_outputs_match_jax(both):
    """Every level and stage. f32: 1e-4 on logits and offset fields, 5e-4
    on the moment boxes (their sqrt/exp), as tests/test_torch_model.py."""
    got, want = both['touts'], both['jouts']
    n_levels = 1 if both['head'] == 'KGDetHead1Rep' else 3
    assert len(got) == len(want) == n_levels
    keys = ('cls', 'kpt', 'bbox') if n_levels == 1 \
        else ('cls', 'kpt', 'bbox', 'rep')
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w) == sorted(keys)
        for k in keys:
            tol = 5e-4 if k == 'bbox' else 1e-4
            assert g[k].shape == w[k].shape, (lvl, k)
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=tol, atol=tol,
                                       err_msg=f'{k} lvl{lvl}')
    if n_levels == 3:
        assert got[0]['cls'].shape == (1, 2, 8, 12, 13)
        assert got[2]['kpt'].shape == (2, 2, 2, 3, 2 * KPTS)
        assert got[1]['rep'].shape == (2, 2, 4, 6, 18)
        if both['head'] == 'RepPointsHead':
            assert not got[0]['kpt'].any()
        else:
            assert got[0]['kpt'][1].abs().max() > 0.1


def test_loss_terms_match_jax(both):
    """The total and each term by name; f32, 1e-4 relative (the outputs
    agree to 1e-4). A term that is exactly zero on one side (the keypoint
    terms of plain RepPoints before any positive) is held to 1e-6."""
    want, got = both['jlogs'], both['tlogs']
    assert sorted(got) == sorted(want)
    if both['head'] == 'KGDetHead1Rep':
        assert len(got) == 10
    else:
        assert len(got) == 3 * 5 + 2
        assert {'loss_cls_lvl0', 'loss_bbox_init_lvl1',
                'loss_kpt_refine_lvl2', 'num_pos_init',
                'num_pos_refine'} <= set(got)
        assert want['num_pos_refine'] >= 2
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(both['ttotal'], both['jtotal'], rtol=1e-4)


def test_every_parameter_gradient_matches_jax(both):
    """f32, within 1e-4 of each gradient's largest value (5e-4 on
    moment_transfer, whose gradient passes the moment boxes' sqrt/exp).
    Parameters below the frozen cut, and those the loss does not reach,
    have no gradient in the port and an exactly zero one in JAX. The init
    stage's output layers are named: the refine stage reaches them only
    through grad_pos of the sampling backward times the gradient
    multiplier, so a wrong sign or (y, x) order shows there."""
    jg, tg = _named(both['jgrads']), both['tgrads']
    assert sorted(jg) == sorted(tg)
    checked = 0
    for name, want in jg.items():
        got = tg[name]
        if got is None:
            assert not want.any(), name
            continue
        tol = 5e-4 if name.endswith('moment_transfer') else 1e-4
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, atol=tol * scale,
                                   rtol=0, err_msg=name)
        checked += 1
    assert checked > 100
    named = {
        'SerialKpHead': ('reppts_init_out.weight', 'keypts_init_out.weight',
                         'keypts_refine_dfmconv.weight',
                         'cls_refine_dfmconv.weight'),
        'ParallelKpHead': ('reppts_init_out.weight',
                           'reppts_init_conv.weight',
                           'reppts_refine_dfmconv.weight',
                           'keypts_refine_dfmconv.weight'),
        'RepPointsHead': ('reppts_init_out.weight',
                          'reppts_refine_dfmconv.weight',
                          'cls_refine_dfmconv.weight'),
        'KGDetHead1Rep': ('kp_rep_block_1.reppts_out.weight',
                          'kp_rep_block_2.cls_dfmconv.weight',
                          'kp_rep_block_3.keypts_dfmconv.weight'),
    }[both['head']]
    for name in named:
        name = 'bbox_head.' + name
        assert np.abs(jg[name]).max() > 0, name
        assert tg[name] is not None, name


def test_optimizer_step_on_shared_gradients_matches_jax(both):
    """One SGD step of both optimizers on JAX's gradients, under paramwise
    multipliers and a warmup: each parameter within 1e-4 of its own move
    plus two ulps of its largest value (f32 rounding; the clip factor's
    norm is summed in another order)."""
    cfg, jgrads = both['cfg'], both['jgrads']
    jstart = both['variables']['params']
    tx, _ = jtrain.make_optimizer(cfg, jstart, 100)

    def update(g, p):               # compiled once: eager optax is slow
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates), optax.global_norm(g)
    jnew, jnorm = jax.jit(update)(jgrads, jstart)
    want = _named(jnew)
    start = _named(jstart)
    probe = build_model(cfg, device='cpu')
    probe.load_state_dict(both['model'].state_dict())
    opt, _ = ttrain.make_optimizer(cfg, probe, 100)
    first = _named(jgrads)
    for name, p in probe.named_parameters():
        p.grad = torch.from_numpy(first[name])
    norm = opt.step()
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-4)
    moved = 0
    for name, p in probe.named_parameters():
        move = np.abs(want[name] - start[name]).max()
        np.testing.assert_allclose(
            p.detach().numpy(), want[name], rtol=0, err_msg=name,
            atol=1e-4 * move + 2.4e-7 * np.abs(want[name]).max())
        moved += move > 0
    assert moved > 50


def test_predict_matches_jax(both):
    """Padded detections after decode and NMS over all levels: the same
    slots valid, the same labels, boxes and keypoints within 1e-3."""
    cfg, model = both['cfg'], both['model'].eval()
    rng = np.random.RandomState(5)
    batch = {'image': rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8),
             'img_hw': np.asarray([[64, 96], [56, 80]], np.float32),
             'scale_factor': np.asarray([1.0, 0.75], np.float32)}
    want = jmake_predict_fn(both['jmodel'], cfg, CANVAS)(
        both['variables'], {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_predict_fn(model, cfg, CANVAS)(batch)
    valid = np.asarray(want['valid'])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['det_labels'].numpy(),
                                  np.asarray(want['det_labels']))
    for k in ('det_bboxes', 'det_kpts'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


def test_state_dict_round_trip(both):
    """port state_dict -> torch_convert -> flax leaves: no key skipped,
    every leaf present, every array back as it was."""
    variables = both['variables']
    params, stats, skipped = convert_state_dict(both['model'].state_dict())
    assert skipped == []
    merged = merge_into_variables(variables, params, stats, strict=True)
    flat = jax.tree_util.tree_flatten_with_path
    assert len(flat(params)[0]) + len(flat(stats)[0]) \
        == len(flat(variables)[0])
    for (pa, a), (pb, b) in zip(flat(merged)[0], flat(variables)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('head_type', HEAD_TYPES)
def test_entry_points_take_the_family(head_type):
    """init_trainer builds each family on the CPU when asked, takes a step
    with finite logs named by the family's loss, leaves a frozen parameter
    bit-equal and moves a free one; without a device argument it raises
    where there is no card."""
    cfg = family_cfg(head_type)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            init_trainer(cfg, CANVAS, 100)
    model, opt, step = init_trainer(cfg, CANVAS, 100, device='cpu')
    params = dict(model.named_parameters())
    frozen, free = 'backbone.layer1.0.conv1.weight', \
        'bbox_head.cls_convs.0.conv.weight'
    before = {n: params[n].detach().clone() for n in (frozen, free)}
    logs = step(_train_batch(cfg.head.num_keypts))
    assert all(torch.isfinite(v) for v in logs.values())
    assert logs['grad_norm'] > 0
    assert ('num_pos' in logs) == (head_type == 'KGDetHead1Rep')
    assert torch.equal(params[frozen].detach(), before[frozen])
    assert not torch.equal(params[free].detach(), before[free])


def test_plain_kernels_reach_the_serial_head(monkeypatch):
    """Every deformable conv of the serial head (K1 under autograd: K6
    forward, K3 backward) finds the rule saying plain inside
    plain_kernels(), and kernel outside it."""
    import kgdet_tpu_torch.models.serial_head as serial_head
    from kgdet_tpu_torch.ops import plain_kernels, runs_kernel
    head = build_model(family_cfg('ParallelKpHead'),
                       device='cpu').bbox_head
    seen, fused = [], serial_head.deform_conv_fused
    card = torch.empty(0, device='meta')

    def recording(*a):
        seen.append(runs_kernel(card))
        return fused(*a)
    monkeypatch.setattr(serial_head, 'deform_conv_fused', recording)
    x = torch.zeros(1, 64, 2, 3)
    with torch.no_grad():
        for plain in (True, False):
            with plain_kernels(plain):
                head.run_level(x)
    assert seen == [False, False, True, True]
