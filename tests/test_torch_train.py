"""The port's training step (kgdet_tpu_torch.parallel.train) against
kgdet_tpu's, whole.

The tiny R-50 KGDet model of tests/test_torch_model.py is initialized by the
JAX package, its variables are carried into the port through
``state_dict_from_jax``, and both take the same batch
(tests/common.py::synth_batch) on the CPU in f32: the loss and every log
term, every parameter's gradient, then three optimizer steps under a config
with paramwise multipliers and a two-step warmup (the optimizer on shared
gradients, tightly, and the free-running step within its own sensitivity).
The ``adam`` branch of the optimizer takes the same shared gradients against
the optax chain, and the demo-overfit config (``adam``, nothing frozen) takes
one train step at tiny width. Tolerances are stated at each assert.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.config import KGDetConfig, OptimConfig
from kgdet_tpu.parallel import train as jtrain
from kgdet_tpu_torch.api import build_model, init_trainer
from kgdet_tpu_torch.parallel import train as ttrain
from kgdet_tpu_torch.utils.convert import state_dict_from_jax
from tests.common import synth_batch
from tests.test_torch_model import _perturb, tiny_r50_cfg

torch.set_num_threads(1)
CANVAS = (96, 128)
STEPS_PER_EPOCH = 100


def train_cfg():
    """tiny_r50_cfg with every paramwise multiplier off 1 and a warmup
    short enough that the three steps see three learning rates."""
    return tiny_r50_cfg().replace(optim=OptimConfig(
        bias_lr_mult=2.0, bias_decay_mult=0.0, norm_decay_mult=0.5,
        warmup_iters=2))


def _named(tree):
    """A flax params-shaped tree -> {torch parameter name: numpy array}."""
    return {k: v.numpy() for k, v in
            state_dict_from_jax({'params': tree}).items()}


@pytest.fixture(scope='module')
def both():
    cfg = train_cfg()
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

    (_, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)

    tx, _ = jtrain.make_optimizer(cfg, params, STEPS_PER_EPOCH)
    opt_state = tx.init(params)
    jstep = jax.jit(jtrain.make_train_step(jmodel, cfg, CANVAS, tx))
    jlogs, jparams, p = [], [], params
    for _ in range(3):
        p, opt_state, logs = jstep(p, stats, opt_state, jbatch)
        jlogs.append({k: float(v) for k, v in logs.items()})
        jparams.append(_named(p))

    model = build_model(cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    start = {k: v.detach().clone() for k, v in model.named_parameters()}
    loss_only = ttrain.make_loss_fn(model, cfg, CANVAS)
    total, _ = loss_only(batch)
    total.backward()
    tgrads = {k: None if v.grad is None else v.grad.clone()
              for k, v in model.named_parameters()}
    opt, _ = ttrain.make_optimizer(cfg, model, STEPS_PER_EPOCH)
    tstep = ttrain.make_train_step(model, cfg, CANVAS, opt)
    tlogs, tparams1 = [], None
    for _ in range(3):
        tlogs.append({k: v.item() for k, v in tstep(batch).items()})
        if tparams1 is None:
            tparams1 = {k: v.detach().numpy().copy()
                        for k, v in model.named_parameters()}
    return dict(cfg=cfg, model=model, start=start, jgrads=_named(jgrads),
                jgrads_tree=jgrads, params_tree=params, tgrads=tgrads,
                jlogs=jlogs, tlogs=tlogs, tparams1=tparams1, jparams=jparams,
                jstart=_named(params))


def _jit_update(tx):
    """One optax step on ``mult`` times the gradients, compiled once:
    (new params, new state, the scaled gradients' global norm)."""
    import optax

    def update(grads, mult, state, params):
        g = jax.tree.map(lambda x: x * mult, grads)
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state, \
            optax.global_norm(g)
    return jax.jit(update)


def test_first_step_logs_match_jax(both):
    """Loss, the nine terms, num_pos and grad_norm (before clipping) of the
    first step; f32, 1e-4 relative (the model outputs agree to 1e-4)."""
    want, got = both['jlogs'][0], both['tlogs'][0]
    assert sorted(got) == sorted(want) and len(got) == 12
    for k in want:
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_every_parameter_gradient_matches_jax(both):
    """f32, within 1e-4 of each gradient's max (5e-4 on moment_transfer,
    whose gradient passes the moment boxes' sqrt/exp). Parameters below the
    frozen cut have no gradient in the port and an exactly zero one in
    JAX. keypts_out and reppts_out of stages 1 and 2 are named: they are
    reached only through grad_pos of the sampling backward (times the
    gradient multiplier 0.1), so a wrong sign or (y, x) order shows
    there."""
    jg, tg = both['jgrads'], both['tgrads']
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
    for name in ('bbox_head.kp_rep_block_1.reppts_out.weight',
                 'bbox_head.kp_rep_block_1.keypts_out.weight',
                 'bbox_head.kp_rep_block_2.reppts_out.weight',
                 'bbox_head.kp_rep_block_2.keypts_out.bias',
                 'bbox_head.kp_rep_block_3.cls_dfmconv_7.weight',
                 'bbox_head.reg_convs.0.conv.weight',
                 'backbone.layer4.2.conv3.weight'):
        assert np.abs(jg[name]).max() > 0, name
        assert tg[name] is not None, name


def test_three_optimizer_steps_match_jax(both):
    """Three optimizer steps, in two parts.

    The optimizer alone: both take the same gradients (JAX's first-step
    gradients scaled by 1, 3 and 0.5, so the second step's norm of about 61
    is clipped at 35) through the two-step warmup. Parameters then differ
    only by f32 rounding and by the clip factor, whose norm the two sum in
    another order: 1e-4 of that parameter's largest move plus two ulps of
    its largest value.

    The whole step, free-running: this model's gradients are sensitive (the
    JAX step run twice from parameters 1e-6 apart, relative, differs by about
    1% of a move after one step and 17% after three), so each parameter is
    held to 0.1 of its own move after the first step, and the later steps'
    logs to 1e-3 on the loss and its terms and 2e-2 on the gradient norm."""
    cfg, model = both['cfg'], both['model']
    jgrads, jstart = both['jgrads_tree'], both['params_tree']
    tx, _ = jtrain.make_optimizer(cfg, jstart, STEPS_PER_EPOCH)
    probe = build_model(cfg, device='cpu')
    probe.load_state_dict({**model.state_dict(),
                           **{k: v.clone() for k, v in both['start'].items()}})
    opt, _ = ttrain.make_optimizer(cfg, probe, STEPS_PER_EPOCH)
    state, jp = tx.init(jstart), jstart
    first = _named(jgrads)
    update = _jit_update(tx)
    for mult in (1.0, 3.0, 0.5):
        jp, state, g_norm = update(jgrads, np.float32(mult), state, jp)
        for name, p in probe.named_parameters():
            p.grad = torch.from_numpy(first[name] * np.float32(mult))
        norm = opt.step()
        # f32 sums of 2e7 squares in two orders agree to about 1e-5
        np.testing.assert_allclose(norm.item(), float(g_norm), rtol=1e-4)
    want, start = _named(jp), both['jstart']
    moved = 0
    for name, p in probe.named_parameters():
        move = np.abs(want[name] - start[name]).max()
        np.testing.assert_allclose(
            p.detach().numpy(), want[name], rtol=0, err_msg=name,
            atol=1e-4 * move + 2.4e-7 * np.abs(want[name]).max())
        moved += move > 0
    assert moved > 100

    after1 = both['jparams'][0]
    for name, got in both['tparams1'].items():
        move = np.abs(after1[name] - start[name]).max()
        np.testing.assert_allclose(got, after1[name], rtol=0, err_msg=name,
                                   atol=0.1 * move + 1e-7)
    for want_logs, got_logs in zip(both['jlogs'][1:], both['tlogs'][1:]):
        for k in want_logs:
            np.testing.assert_allclose(
                got_logs[k], want_logs[k], err_msg=k,
                rtol=2e-2 if k == 'grad_norm' else 1e-3)


def test_three_adam_steps_match_optax_chain(both):
    """``OptimConfig(type='adam')``: the port's update against the JAX
    package's optax chain (clip, L2 folded into the gradient,
    ``scale_by_adam`` with bias correction, scheduled LR, paramwise LR
    multiplier, frozen mask) on shared gradients (JAX's first-step gradients
    scaled by 1, 3 and 0.5, the second clipped) over three steps of the
    two-step warmup. f32: every parameter within 1e-6 absolute (a step moves
    an element by about the LR, 2e-3 to 1e-2 here, so 1e-4 of a move)."""
    cfg = both['cfg']
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, type='adam'))
    jgrads, jstart = both['jgrads_tree'], both['params_tree']
    tx, _ = jtrain.make_optimizer(cfg, jstart, STEPS_PER_EPOCH)
    probe = build_model(cfg, device='cpu')
    probe.load_state_dict({**both['model'].state_dict(),
                           **{k: v.clone() for k, v in both['start'].items()}})
    opt, _ = ttrain.make_optimizer(cfg, probe, STEPS_PER_EPOCH)
    state, jp = tx.init(jstart), jstart
    first = _named(jgrads)
    update = _jit_update(tx)
    for mult in (1.0, 3.0, 0.5):
        jp, state, _ = update(jgrads, np.float32(mult), state, jp)
        for name, p in probe.named_parameters():
            p.grad = torch.from_numpy(first[name] * np.float32(mult))
        opt.step()
    want, start = _named(jp), both['jstart']
    frozen = ttrain.frozen_param_mask(probe, cfg.backbone.frozen_stages)
    moved = 0
    for name, p in probe.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-6, err_msg=name)
        move = np.abs(want[name] - start[name]).max()
        assert move == 0 or not frozen[name], name
        moved += move > 1e-3
    assert moved > 100
    with pytest.raises(ValueError, match='optimizer type'):
        ttrain.make_optimizer(cfg.replace(optim=dataclasses.replace(
            cfg.optim, type='lamb')), probe, STEPS_PER_EPOCH)


def test_demo_overfit_config_takes_a_train_step():
    """configs/kgdet_moment_r50_fpn_1x_demo_overfit.py (``adam``,
    ``frozen_stages=-1``: the whole backbone under autograd) cut to tiny
    widths: one train step on a synthetic batch on the CPU gives a finite
    loss and gradient norm and moves the stem, which no other trained config
    frees."""
    import os

    from kgdet_tpu_torch.api import load_config
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    full = load_config(os.path.join(
        root, 'configs', 'kgdet_moment_r50_fpn_1x_demo_overfit.py'))
    assert full.optim.type == 'adam' and full.backbone.frozen_stages == -1
    tiny = tiny_r50_cfg()
    cfg = full.replace(
        neck=dataclasses.replace(full.neck, out_channels=64),
        head=dataclasses.replace(
            full.head, in_channels=64, feat_channels=64,
            point_feat_channels=64, stacked_convs=1, num_keypts=12,
            gn_groups=8),
        test=tiny.test)
    model, opt, step = init_trainer(cfg, CANVAS, STEPS_PER_EPOCH,
                                    device='cpu')
    assert opt.second_moment is not None
    stem = dict(model.named_parameters())['backbone.conv1.weight']
    before = stem.detach().clone()
    batch = synth_batch(canvas=CANVAS, B=2, G=4, K=cfg.head.num_keypts)
    logs = {k: v.item() for k, v in step(batch).items()}
    assert np.isfinite(logs['loss']) and np.isfinite(logs['grad_norm'])
    assert logs['grad_norm'] > 0 and opt.step_count == 1
    assert not torch.equal(stem.detach(), before)


def test_frozen_parameters_stay_bit_equal(both):
    model, start = both['model'], both['start']
    frozen = ttrain.frozen_param_mask(model, both['cfg'].backbone
                                      .frozen_stages)
    n_frozen = 0
    for name, p in model.named_parameters():
        if frozen[name]:
            assert torch.equal(p.detach(), start[name]), name
            n_frozen += 1
    assert frozen['backbone.conv1.weight'] \
        and frozen['backbone.layer1.2.bn3.bias'] \
        and not frozen['backbone.layer2.0.conv1.weight']
    assert n_frozen == sum(frozen.values()) > 30
    free = 'backbone.layer3.0.conv1.weight'
    assert not torch.equal(dict(model.named_parameters())[free].detach(),
                           start[free])


def test_lr_schedule_matches_jax():
    """The five points of tests/test_train_step.py::test_lr_schedule_shape
    and each step of the warmup's end."""
    cfg = KGDetConfig()
    want = jtrain.make_lr_schedule(cfg, steps_per_epoch=1000)
    got = ttrain.make_lr_schedule(cfg, steps_per_epoch=1000)
    for step in (0, 500, 5000, 8 * 1000 + 1, 11 * 1000 + 1, 1, 250, 499,
                 7999, 8000, 11000):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step
    assert got(0) == pytest.approx(cfg.optim.lr / 3, rel=1e-6)
    assert got(11001) == pytest.approx(cfg.optim.lr * 0.01, rel=1e-6)


def test_paramwise_multipliers_match_jax(both):
    cfg, model = both['cfg'], both['model']
    o = dataclasses.replace(cfg.optim, bias_lr_mult=3.0, bias_decay_mult=0.25,
                            norm_decay_mult=0.0)
    jmodel = jbuild_model(cfg)
    params = jax.eval_shape(
        lambda: init_variables(jmodel, cfg, canvas_hw=(64, 64)))['params']
    jlr, jdecay = jtrain.paramwise_multipliers(params, o)
    tlr, tdecay = ttrain.paramwise_multipliers(model, o)

    def named_scalars(tree):      # each multiplier spread over its leaf
        return {k: float(v.flat[0]) for k, v in _named(jax.tree.map(
            lambda m, leaf: np.full(leaf.shape, m, np.float32), tree,
            params)).items()}

    want_lr, want_decay = named_scalars(jlr), named_scalars(jdecay)
    assert sorted(tlr) == sorted(want_lr)
    for name in tlr:
        assert tlr[name] == want_lr[name], name
        assert tdecay[name] == want_decay[name], name
    assert tlr['bbox_head.kp_rep_block_2.cls_out.bias'] == 3.0
    assert tdecay['backbone.layer2.0.bn1.bias'] == 0.0
    assert tdecay['neck.lateral_convs.0.gn.weight'] == 0.0
    assert tlr['bbox_head.moment_transfer'] == 1.0


def test_training_entry_points_default_to_the_card():
    """device=None means the CUDA card: without one the entry points raise
    and do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    cfg = tiny_r50_cfg()
    with pytest.raises(RuntimeError, match='CUDA'):
        init_trainer(cfg, CANVAS, STEPS_PER_EPOCH)
    with pytest.raises(RuntimeError, match='CUDA'):
        build_model(cfg)
    model, opt, step = init_trainer(cfg, CANVAS, STEPS_PER_EPOCH,
                                    device='cpu')
    assert next(model.parameters()).device.type == 'cpu'
    assert opt.step_count == 0


def test_overfit_reaches_high_ap_and_kpt_accuracy():
    """The port's learning proof, tests/test_overfit.py's on the port:
    the tiny R-50 cascade (tests/test_overfit.py's R-18 has no port)
    trained by the port's make_train_step with ``adam`` at 2e-3 after 10
    warmup steps on that test's two fixed images, up to 300 steps (from
    step 50 on, stopping at a check every 25 steps once AP >= 0.99 and the
    keypoint error < 4 px), then held to that test's bounds: the loss below
    a quarter of its start, bbox AP@0.5 on the training images (the port's
    make_predict_fn, detections_to_per_class and eval_map) at least 0.5 and
    0.3 over the untrained model's, and the best detection's keypoints of
    image 0 within 4 px of its first ground truth's on average."""
    from kgdet_tpu_torch.api import make_predict_fn
    from kgdet_tpu_torch.core.postprocess import detections_to_per_class
    from kgdet_tpu_torch.eval.mean_ap import eval_map
    from tests.test_overfit import H, K, W, overfit_batch

    cfg = tiny_r50_cfg().replace(optim=OptimConfig(
        type='adam', lr=2e-3, warmup_iters=10, lr_step_epochs=(1000,),
        total_epochs=1))
    assert cfg.head.num_keypts == K
    model, _, step = init_trainer(cfg, (H, W), 10 ** 6, device='cpu')
    batch = overfit_batch()
    predict = make_predict_fn(model, cfg, (H, W))
    feed = {'image': batch['image'],
            'img_hw': np.asarray([[H, W]] * 2, np.float32),
            'scale_factor': np.ones((2,), np.float32)}
    gt_b = [batch['gt_bboxes'][b][batch['gt_mask'][b]] for b in range(2)]
    gt_l = [batch['gt_labels'][b][batch['gt_mask'][b]] for b in range(2)]

    def evaluate():
        model.eval()
        dets = predict(feed)
        model.train()
        per = detections_to_per_class(dets, num_classes=13)
        m, _ = eval_map([r[0] for r in per], gt_b, gt_l, iou_thr=0.5)
        b0 = dets['det_bboxes'][0].numpy()
        v0 = dets['valid'][0].numpy()
        kerr = np.inf
        if v0.any():
            i = int(np.argmax(np.where(v0, b0[:, 4], -1)))
            kp = dets['det_kpts'][0][i].numpy().reshape(K, 3)
            kerr = float(np.linalg.norm(
                kp[:, :2] - batch['gt_kpts'][0, 0, :, :2], axis=-1).mean())
        return m, kerr

    ap0, _ = evaluate()
    losses = []
    ap, kerr = 0.0, np.inf
    for i in range(300):
        losses.append(step(batch)['loss'].item())
        if i >= 49 and (i + 1) % 25 == 0:
            ap, kerr = evaluate()
            if ap >= 0.99 and kerr < 4.0:
                break
    print(f'steps {len(losses)}, loss {losses[0]:.4f} -> {losses[-1]:.4f}, '
          f'AP@0.5 {ap0:.3f} -> {ap:.3f}, keypoint error {kerr:.2f} px')
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.25, (losses[0], losses[-1])
    assert ap >= 0.5, f'train-set AP@0.5 {ap} (untrained {ap0})'
    assert ap > ap0 + 0.3
    assert kerr < 4.0, f'mean keypoint error {kerr}px'
