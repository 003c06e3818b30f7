"""The port's serving path (kgdet_tpu_torch) against kgdet_tpu, whole, and
the port's own config loader against kgdet_tpu's on every config file.

One tiny KGDet model (R-50 with frozen_stages=1, FPN at 64 channels with
select_out=(2,), a 64-channel head with one tower conv, 12 keypoints and
8 GN groups) is initialized by the JAX package, its variables are carried
into the port through ``state_dict_from_jax``, and both run the same inputs
on the CPU. Tolerances: 1e-4 on head outputs and 5e-4 on the moment boxes
(tests/test_reference_parity.py); 1e-3 on decoded detections.
"""
import dataclasses
import glob
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
from kgdet_tpu.config import BackboneConfig, DataConfig, HeadConfig, \
    KGDetConfig, NeckConfig
from kgdet_tpu.config import TestConfig as TestCfg
from kgdet_tpu.utils.torch_convert import (convert_state_dict,
                                           merge_into_variables)
from kgdet_tpu.config import load_config as jload_config
from kgdet_tpu_torch import config as tconfig
from kgdet_tpu_torch.api import Detector, build_model, init_detector, \
    make_predict_fn
from kgdet_tpu_torch.ops import plain_kernels, runs_kernel
from kgdet_tpu_torch.utils.convert import state_dict_from_jax

torch.set_num_threads(1)
CANVAS = (64, 96)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_r50_cfg():
    return KGDetConfig(
        backbone=BackboneConfig(depth=50, frozen_stages=1),
        neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=64,
                        select_out=(2,), gn_groups=32),
        head=HeadConfig(num_classes=13, in_channels=64, feat_channels=64,
                        point_feat_channels=64, stacked_convs=1,
                        num_keypts=12, gn_groups=8),
        test=TestCfg(nms_pre=50, max_per_class=10, max_per_img=20,
                     score_thr=0.0),
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
        if keys[-1] == 'kernel' and keys[-2] in ('cls_out', 'keypts_out',
                                                 'reppts_out'):
            return v * 30
        return v
    return jax.tree_util.tree_map_with_path(f, variables)


@pytest.fixture(scope='module')
def models():
    cfg = tiny_r50_cfg()
    jmodel = jbuild_model(cfg)
    variables = _perturb(init_variables(jmodel, cfg, canvas_hw=CANVAS))
    port = build_model(cfg, device='cpu')
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return cfg, jmodel, variables, port.eval()


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {
        'image': rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8),
        'img_hw': np.asarray([[64, 96], [56, 80]], np.float32),
        'scale_factor': np.asarray([1.0, 0.75], np.float32),
    }


def test_head_outputs_match_jax(models):
    cfg, jmodel, variables, port = models
    img = np.random.RandomState(1).randn(2, *CANVAS, 3).astype(np.float32)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    assert len(got) == len(want) == 1
    for k, tol in (('cls', 1e-4), ('kpt', 1e-4), ('bbox', 5e-4)):
        g, w = got[0][k].numpy(), np.asarray(want[0][k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol, err_msg=k)


def test_predict_matches_jax(models):
    cfg, jmodel, variables, port = models
    batch = _batch()
    want = jmake_predict_fn(jmodel, cfg, CANVAS)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_predict_fn(port, cfg, CANVAS)(batch)
    valid = np.asarray(want['valid'])
    assert valid.sum() > 0
    np.testing.assert_array_equal(got['valid'].numpy(), valid)
    np.testing.assert_array_equal(got['det_labels'].numpy(),
                                  np.asarray(want['det_labels']))
    for k in ('det_bboxes', 'det_kpts'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


@pytest.mark.parametrize('entry,plain', [
    ('predict', False), ('predict', True), ('aug_call', False),
    ('aug_call', True)])
def test_plain_kernels_reach_the_decode_nms(models, monkeypatch, entry,
                                            plain):
    """plain_kernels() is the one switch for every kernel: the decode's
    greedy NMS, under make_predict_fn and Detector.aug_call inside the
    block, finds the rule saying plain (on the card K9 gives way to its
    loop with the model's other kernels), and kernel after it."""
    from kgdet_tpu_torch.ops import nms
    cfg, _, _, port = models
    seen, greedy = [], nms.greedy_nms
    card = torch.empty(0, device='meta')

    def recording(*a, **kw):
        seen.append(runs_kernel(card))
        return greedy(*a, **kw)
    monkeypatch.setattr(nms, 'greedy_nms', recording)
    with plain_kernels(plain):
        if entry == 'predict':
            make_predict_fn(port, cfg, CANVAS)(_batch())
        else:
            img = np.random.RandomState(3).randint(0, 256, (40, 60, 3))
            Detector(cfg, port).aug_call(img.astype(np.uint8), flip=False,
                                         score_thr=0.0)
    assert seen == [not plain]
    assert runs_kernel(card)


def test_state_dict_round_trip(models):
    """port state_dict -> torch_convert -> flax leaves: nothing skipped,
    every leaf present, every array back as it was."""
    cfg, jmodel, variables, port = models
    params, stats, skipped = convert_state_dict(port.state_dict())
    assert skipped == []
    merged = merge_into_variables(variables, params, stats, strict=True)
    flat = jax.tree_util.tree_flatten_with_path
    conv_leaves = len(flat(params)[0]) + len(flat(stats)[0])
    assert conv_leaves == len(flat(variables)[0])
    for (pa, a), (pb, b) in zip(flat(merged)[0], flat(variables)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_detector_single_image(models):
    cfg, _, _, port = models
    img = np.random.RandomState(2).randint(0, 256, (40, 60, 3)) \
        .astype(np.uint8)
    boxes, labels, kpts = Detector(cfg, port)(img)
    assert boxes.shape[1] == 5 and len(boxes) == len(labels) == len(kpts)
    assert kpts.shape[1:] == (cfg.head.num_keypts, 3)
    assert len(boxes) > 0 and np.isfinite(boxes).all()


def test_other_families_raise():
    """The two-stage families with masks, which raised NotImplementedError
    naming ROADMAP Queue 1 item 6 until they were ported, build (held
    against the JAX package in tests/test_torch_mask_families.py);
    GA-Retina and FCOS build (their heads the port's modules of the same
    name); an unknown head name raises KeyError, as the JAX registry
    does."""
    from kgdet_tpu.models.families import get_head_family as jget_family
    from kgdet_tpu_torch.models.fcos_head import FCOSHead
    from kgdet_tpu_torch.models.ga_head import GARetinaHead
    cfg = tiny_r50_cfg().replace(detector_type='mask_rcnn')
    assert hasattr(build_model(cfg, device='cpu'), 'mask_head')
    cfg = tiny_r50_cfg()
    for head_type, cls in (('GARetinaHead', GARetinaHead),
                           ('FCOSHead', FCOSHead)):
        good = cfg.replace(head=dataclasses.replace(cfg.head,
                                                    type=head_type))
        assert type(build_model(good, device='cpu').bbox_head) is cls
        assert jget_family(head_type) is not None
    bad = cfg.replace(head=dataclasses.replace(cfg.head, type='nope'))
    with pytest.raises(KeyError, match='unknown head family nope'):
        build_model(bad, device='cpu')
    with pytest.raises(KeyError, match='unknown head family nope'):
        jget_family('nope')


def test_port_runs_without_jax_flax_cv2():
    """The port imports, loads every config file, serves a batch and takes
    a train step (the KGDet cascade, then each of the serial, parallel,
    plain RepPoints and single-column families, RetinaNet, SSD, the
    cascade on the DCN backbone, FCOS and GA-Retina; runs the backbones
    and necks of the four two-stage configs and the three plugins; Faster
    R-CNN, Cascade R-CNN and RPN serve a batch and take a step; then
    the cascade in a process group of one), after importing every module
    of the port, with jax, flax, cv2 and kgdet_tpu unavailable, as on the
    GPU machine."""
    code = '\n'.join([
        'import glob, sys',
        "for m in ('jax', 'flax', 'cv2', 'kgdet_tpu'):",
        '    sys.modules[m] = None',
        'import numpy as np, torch',
        'torch.set_num_threads(1)',
        'from kgdet_tpu_torch.config import (BackboneConfig, HeadConfig, '
        'KGDetConfig, NeckConfig, TestConfig, load_config)',
        'from kgdet_tpu_torch.api import build_model, init_trainer, '
        'make_predict_fn',
        "paths = sorted(glob.glob('configs/*.py'))",
        'assert len(paths) >= 17',
        'for path in paths:',
        '    assert isinstance(load_config(path), KGDetConfig), path',
        "assert sys.modules['kgdet_tpu'] is None",
        # every module of the port, the newest included
        'import importlib, pkgutil, kgdet_tpu_torch',
        'for m in pkgutil.walk_packages(kgdet_tpu_torch.__path__, '
        "'kgdet_tpu_torch.'):",
        '    importlib.import_module(m.name)',
        "assert 'kgdet_tpu_torch.models.ga_head' in sys.modules",
        "assert 'kgdet_tpu_torch.utils.bn_calibration' in sys.modules",
        "assert 'kgdet_tpu_torch.tools.test_robustness' in sys.modules",
        'cfg = KGDetConfig(backbone=BackboneConfig(depth=50, '
        'frozen_stages=1), neck=NeckConfig(out_channels=64), '
        'head=HeadConfig(in_channels=64, feat_channels=64, '
        'stacked_convs=1, num_keypts=12, gn_groups=8), '
        'test=TestConfig(nms_pre=50, max_per_class=10, max_per_img=20, '
        'score_thr=0.0))',
        "model = build_model(cfg, device='cpu').init_weights(0).eval()",
        'rng = np.random.RandomState(0)',
        "batch = {'image': rng.randint(0, 256, (1, 64, 96, 3))"
        ".astype(np.uint8), 'img_hw': np.array([[64, 96]], np.float32),"
        " 'scale_factor': np.ones(1, np.float32)}",
        'dets = make_predict_fn(model, cfg, (64, 96))(batch)',
        "assert dets['valid'].any()",
        "model, opt, step = init_trainer(cfg, (64, 96), 10, device='cpu')",
        "w = model.bbox_head.kp_rep_block_3.cls_out.weight",
        "before = w.detach().clone()",
        "train_batch = {'image': batch['image'], "
        "'valid_hw': batch['img_hw'], "
        "'gt_bboxes': np.array([[[8, 8, 60, 50]]], np.float32), "
        "'gt_labels': np.ones((1, 1), np.int32), "
        "'gt_kpts': np.concatenate([rng.uniform(8, 50, (1, 1, 12, 2)), "
        "np.ones((1, 1, 12, 1))], -1).astype(np.float32), "
        "'gt_mask': np.ones((1, 1), bool)}",
        "logs = step(train_batch)",
        "assert torch.isfinite(logs['loss']) and logs['grad_norm'] > 0",
        "assert not torch.equal(before, w)",
        'import dataclasses',
        'from kgdet_tpu_torch.config import AssignConfig',
        "for head_type in ('SerialKpHead', 'ParallelKpHead', "
        "'RepPointsHead', 'KGDetHead1Rep'):",
        '    fcfg = cfg.replace(head=dataclasses.replace(cfg.head, '
        'type=head_type, num_reppts=9, loss_bbox_weights=(0.5, 1.0, 1.0), '
        'loss_kpt_weights=(2.0, 4.0, 4.0)), '
        'refine_assigner=AssignConfig(type="MaxIoUAssigner"))',
        "    fmodel, _, fstep = init_trainer(fcfg, (64, 96), 10, "
        "device='cpu')",
        "    flogs = fstep(dict(train_batch))",
        "    assert torch.isfinite(flogs['loss']) and flogs['grad_norm'] > 0"
        ", head_type",
        "    fdets = make_predict_fn(fmodel.eval(), fcfg, (64, 96))(batch)",
        "    assert fdets['det_bboxes'].shape == (1, 20, 5), head_type",
        # the anchor families on a 3-level FPN, and the DCN backbone
        "for head_type in ('RetinaHead', 'SSDHead', 'dcn', 'FCOSHead', "
        "'GARetinaHead'):",
        "    fcfg = cfg.replace(neck=dataclasses.replace(cfg.neck, "
        "start_level=1, num_outs=3, select_out=None), "
        "head=dataclasses.replace(cfg.head, type=head_type, "
        "point_strides=(8, 16, 32), ssd_anchor_ratios=((2,), (2, 3), (2,)))"
        ", assigner=AssignConfig(type='MaxIoUAssigner'))",
        "    if head_type == 'dcn':",
        "        fcfg = cfg.replace(backbone=dataclasses.replace("
        "cfg.backbone, dcn_stages=(1, 2, 3)))",
        "    fmodel, _, fstep = init_trainer(fcfg, (64, 96), 10, "
        "device='cpu')",
        "    flogs = fstep(dict(train_batch))",
        "    assert torch.isfinite(flogs['loss']) and flogs['grad_norm'] > 0"
        ", head_type",
        "    fdets = make_predict_fn(fmodel.eval(), fcfg, (64, 96))(batch)",
        "    assert fdets['det_bboxes'].shape == (1, 20, 5), head_type",
        # the backbone and neck extras, as the two-stage configs build them
        'from kgdet_tpu_torch.models.detector import build_backbone, '
        'build_neck',
        "for path in ('faster_rcnn_r50_caffe_c4', 'faster_rcnn_x101_32x4d_"
        "fpn', 'faster_rcnn_hrnetv2p_w32', 'libra_faster_rcnn_r50_fpn'):",
        "    tcfg = load_config(f'configs/{path}_1x_deepfashion2.py')",
        '    feats = build_backbone(tcfg.backbone)(torch.zeros(1, 64, 64, 3))',
        '    neck = build_neck(tcfg.neck)',
        '    outs = feats if neck is None else neck(feats)',
        '    assert all(torch.isfinite(o).all() for o in outs), path',
        'from kgdet_tpu_torch.models.plugins import ContextBlock, '
        'GeneralizedAttention, NonLocal2D',
        'for plugin in (ContextBlock(16), NonLocal2D(16), '
        'GeneralizedAttention(16, num_heads=4)):',
        '    assert plugin(torch.ones(1, 16, 4, 6)).shape == (1, 16, 4, 6)',
        # the box-only two-stage detectors on the same trunk
        "for dt in ('faster_rcnn', 'cascade_rcnn', 'rpn'):",
        "    tcfg = cfg.replace(detector_type=dt, num_proposals_train=16, "
        "num_proposals_test=16, neck=dataclasses.replace(cfg.neck, "
        "start_level=1, num_outs=3, select_out=None), "
        "head=dataclasses.replace(cfg.head, point_strides=(8, 16, 32)))",
        "    tmodel, _, tstep = init_trainer(tcfg, (64, 96), 10, "
        "device='cpu')",
        "    tlogs = tstep(dict(train_batch, seed=np.int32(1)))",
        "    assert torch.isfinite(tlogs['loss']), dt",
        "    tdets = make_predict_fn(tmodel.eval(), tcfg, (64, 96))(batch)",
        "    assert torch.isfinite(tdets['det_bboxes']).all(), dt",
        "ssd = load_config('configs/ssd300_vgg16_deepfashion2.py')",
        "smodel = build_model(ssd, device='cpu').init_weights(0).eval()",
        "sbatch = {'image': rng.randint(0, 256, (1, 300, 300, 3))"
        ".astype(np.uint8), 'img_hw': np.array([[300, 300]], np.float32), "
        "'scale_factor': np.ones(1, np.float32)}",
        "sdets = make_predict_fn(smodel, ssd, (300, 300))(sbatch)",
        "assert sdets['det_kpts'].shape == (1, 200, 3)",
        # the data-parallel code: a group of one process over gloo
        'import os, socket',
        'from kgdet_tpu_torch.parallel.dist import (init_distributed, '
        'replicate, shard_batch, world)',
        'from kgdet_tpu_torch.tools import dp_step',
        "port = socket.create_server(('127.0.0.1', 0))",
        "os.environ.update(RANK='0', WORLD_SIZE='1', MASTER_ADDR="
        "'127.0.0.1', MASTER_PORT=str(port.getsockname()[1]))",
        'port.close()',
        "assert init_distributed('cpu') == torch.device('cpu')",
        'assert world() == (0, 1)',
        'replicate(model)',
        'logs = step(shard_batch(train_batch, 0, 1))',
        "assert torch.isfinite(logs['loss'])",
        "assert dp_step.kernel_launches()['deform_fused'] == 0",
        "print('ok', sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'cv2', 'kgdet_tpu') "
        "and sys.modules[k] is not None))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == 'ok []'


def test_flip_forward_head_matches_jax():
    """fuse_flip: the flip-ensembled head (with a keypoint-channel
    permutation) against the JAX head on the same weights."""
    from kgdet_tpu.models.kgdet_head import KGDetHead as JHead
    from kgdet_tpu_torch.models.kgdet_head import KGDetHead
    rng = np.random.RandomState(3)
    perm = np.arange(24).reshape(12, 2)[rng.permutation(12)].reshape(-1)
    kw = dict(num_classes=13, in_channels=64, feat_channels=64,
              stacked_convs=1, num_keypts=12, gn_groups=8,
              flip_forward=True, flip_indices=tuple(int(i) for i in perm))
    x = rng.randn(2, 3, 5, 64).astype(np.float32)
    jhead = JHead(**kw)
    variables = _perturb(jhead.init(jax.random.PRNGKey(0),
                                    [jnp.asarray(x)]))
    want = jhead.apply(variables, [jnp.asarray(x)])
    state = state_dict_from_jax({'params': {'head': variables['params']}})
    head = KGDetHead(**kw)
    head.load_state_dict({k[len('bbox_head.'):]: v
                          for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = head([torch.from_numpy(x).permute(0, 3, 1, 2)])
    for k, tol in (('cls', 1e-4), ('kpt', 1e-4), ('bbox', 5e-4)):
        np.testing.assert_allclose(got[0][k].numpy(),
                                   np.asarray(want[0][k]), rtol=tol,
                                   atol=tol, err_msg=k)


def test_resnet_unfrozen_stem_equals_folded_prefix(models):
    """frozen_stages=0 runs the plain stem + layer1 (NCHW, unfolded BN);
    it must equal the folded K4/K5 prefix that frozen_stages=1 runs."""
    _, _, _, port = models
    x = torch.from_numpy(np.random.RandomState(4).randn(
        1, 64, 96, 3).astype(np.float32))
    backbone = port.backbone
    with torch.no_grad():
        want = backbone(x)
        backbone.frozen_stages = 0
        try:
            got = backbone(x)
        finally:
            backbone.frozen_stages = 1
    # activations grow to a few hundred by layer4 under random BN stats;
    # the bound is 1e-5 of each stage's scale (f32 summation order only)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item())


def test_resnet_per_block_route_matches_jax_and_the_chain(models):
    """prefix_pipeline=False: the stem and maxpool as PyTorch calls, then
    each frozen layer1 block through fused_bottleneck (K8; its plain
    version on the CPU). Every stage output equals the JAX backbone's
    (whose frozen layer1 runs FusedBottleneck per block off the TPU) and
    the port's K4+K5 chain route; 1e-4 of each stage's scale. No gradient
    reaches the frozen prefix."""
    from kgdet_tpu.models.resnet import ResNet as JResNet
    from kgdet_tpu_torch.models.resnet import ResNet
    from kgdet_tpu_torch.ops.resblock import fused_bottleneck
    cfg, _, variables, port = models
    x = np.random.RandomState(6).randn(1, 64, 96, 3).astype(np.float32)
    want = JResNet.from_config(cfg.backbone, name=None).apply(
        {'params': variables['params']['backbone'],
         'batch_stats': variables['batch_stats']['backbone']},
        jnp.asarray(x))
    net = ResNet(depth=50, frozen_stages=1, prefix_pipeline=False)
    net.load_state_dict(port.backbone.state_dict())
    before = fused_bottleneck.launches
    got = net(torch.from_numpy(x))
    assert fused_bottleneck.launches == before      # CPU: the plain version
    with torch.no_grad():
        chain = port.backbone(torch.from_numpy(x))
    assert len(got) == len(want) == len(chain) == 4
    assert not got[0].requires_grad and got[1].requires_grad
    for g, w, c in zip(got, want, chain):
        atol = 1e-4 * np.abs(np.asarray(w)).max()
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=atol)
        np.testing.assert_allclose(g.detach().numpy(), c.numpy(), rtol=1e-4,
                                   atol=atol)
    got[3].sum().backward()
    assert net.layer1[0].conv1.weight.grad is None
    assert net.layer2[0].conv1.weight.grad is not None


def test_resnet_per_block_route_runs_on_the_kept_weights(monkeypatch):
    """prefix_pipeline=False: each layer1 block goes to
    fused_bottleneck_prepared with the very tuple ResNet.prefix_weights
    keeps for the dtype (the one K5 reads too), and a second forward
    prepares nothing: no fold, cast or copy of a weight. On the CPU no
    launch, and the output equals the plain per-block route bit for bit."""
    import kgdet_tpu_torch.models.resnet as resnet_mod
    from kgdet_tpu_torch.ops.resblock import fused_bottleneck
    net = resnet_mod.ResNet(depth=50, num_stages=1, out_indices=(0,),
                            frozen_stages=1, prefix_pipeline=False)
    net.init_weights(torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.RandomState(7).randn(
        1, 40, 56, 3).astype(np.float32))
    seen, prepared = [], []
    real_block = resnet_mod.fused_bottleneck_prepared
    real_prepare = resnet_mod.prepare_block

    def block(y, blk):
        seen.append(blk)
        return real_block(y, blk)

    def prepare(*a):
        prepared.append(a)
        return real_prepare(*a)
    monkeypatch.setattr(resnet_mod, 'fused_bottleneck_prepared', block)
    monkeypatch.setattr(resnet_mod, 'prepare_block', prepare)
    before = fused_bottleneck.launches
    first = net(x)[0]
    assert len(prepared) == 3
    second = net(x)[0]
    assert len(prepared) == 3 and fused_bottleneck.launches == before
    kept = net.prefix_weights(torch.float32)[1][1]
    assert len(seen) == 6 and all(b is kept[i % 3] for i, b in
                                  enumerate(seen))
    with plain_kernels():
        plain = net(x)[0]
    assert torch.equal(first, second) and torch.equal(first, plain)


@pytest.mark.parametrize('extra_convs', [True, False])
def test_fpn_all_levels_match_jax(extra_convs):
    """Every FPN level, including the stride-2 extra convs (flax 'SAME'
    pads (0, 1) on an even size) or the max-pooled extras."""
    from kgdet_tpu.models.fpn import FPN as JFPN
    from kgdet_tpu_torch.models.fpn import FPN
    kw = dict(in_channels=(8, 16, 32, 64), out_channels=16, start_level=1,
              num_outs=5, add_extra_convs=extra_convs, norm='gn',
              gn_groups=4)
    rng = np.random.RandomState(5)
    xs = [rng.randn(1, 32 // 2 ** i, 48 // 2 ** i, c).astype(np.float32)
          for i, c in enumerate(kw['in_channels'])]
    jfpn = JFPN(**kw)
    variables = jfpn.init(jax.random.PRNGKey(1), [jnp.asarray(x) for x in xs])
    want = jfpn.apply(variables, [jnp.asarray(x) for x in xs])
    state = state_dict_from_jax({'params': {'neck': variables['params']}})
    fpn = FPN(**kw)
    fpn.load_state_dict({k[len('neck.'):]: v for k, v in state.items()},
                        strict=True)
    with torch.no_grad():
        got = fpn([torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-4)


def test_init_detector_loads_reference_style_pth(models, tmp_path):
    """A reference-style .pth (names from tests/test_convert.py's inverse
    walk, num_batches_tracked beside every BN, mmcv's 'state_dict' nesting
    and 'module.' prefixes) loads strictly and serves like the model built
    from the flax variables."""
    from tests.test_convert import _flax_to_torch_state
    cfg, _, variables, port = models
    state = _flax_to_torch_state(variables)
    for k in [k for k in state if k.endswith('.running_mean')]:
        state[k[:-len('running_mean')] + 'num_batches_tracked'] = \
            torch.tensor(7)
    path = tmp_path / 'kgdet.pth'
    torch.save({'state_dict': {'module.' + k: v for k, v in state.items()}},
               path)
    det = init_detector(cfg, pth=str(path), device='cpu')
    batch = _batch(seed=3)
    want = make_predict_fn(port, cfg, CANVAS)(batch)
    got = det._predict_for(CANVAS)(batch)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())


# one key for each of the JAX converter's 22 skip sites, in its order, and
# keys beside them that it maps (with values its layout maps take)
SKIPPED_KEYS = (
    'backbone.stage2.0.branches.0.0.relu.weight',
    'backbone.stage2.0.foo.weight', 'backbone.layer1.0.relu.weight',
    'backbone.fc.weight', 'neck.extra_conv.weight',
    'neck.lateral_convs.0.bn.weight', 'neck.0.lateral_convs.0.bn.weight',
    'backbone.layer2.0.gen_attention_block.foo.weight',
    'backbone.layer2.0.context_block.channel_add_conv.2.weight',
    'backbone.layer2.0.context_block.foo.weight', 'rpn_head.foo.weight',
    'rpn_head.feature_adaption.conv_offset.bias', 'mask_head.foo.weight',
    'mask_head.0.foo.weight', 'grid_head.foo.weight',
    'shared_head.foo.weight', 'shared_head.layer4.0.relu.weight',
    'mask_iou_head.foo.weight', 'semantic_head.foo.weight',
    'bbox_head.0.foo.weight', 'bbox_head.conv_branch.0.relu.weight',
    'bbox_head.cls_convs.0.bn.weight', 'bbox_head.kp_rep_block_1.foo.weight',
    'bbox_head.feature_adaption.conv_offset.bias', 'bbox_head.foo.weight',
    'roi_head.bbox_head.fc_cls.weight', 'num_batches_tracked')
MAPPED_KEYS = (
    'backbone.features.0.weight', 'backbone.layer2.0.conv2_offset.weight',
    'backbone.layer2.0.gen_attention_block.gamma',
    'backbone.layer2.0.context_block.channel_add_conv.3.weight',
    'backbone.stage2.0.fuse_layers.0.1.0.weight', 'rpn_head.rpn_conv.weight',
    'rpn_head.conv_loc.weight', 'mask_head.convs.0.conv.weight',
    'mask_head.1.conv_res.conv.weight', 'grid_head.convs.0.conv.weight',
    'shared_head.layer4.0.conv1.weight', 'mask_iou_head.convs.0.weight',
    'semantic_head.convs.0.conv.weight',
    'neck.1.refine.conv.weight', 'bbox_head.fcos_cls.weight',
    'bbox_head.cls_init_dfmconv.weight', 'bbox_head.reg_convs.0.weight',
    'bbox_head.res_block.conv1.conv.weight')


def test_pth_skip_rule_matches_the_jax_converter():
    """utils/convert.py::converter_skips against convert_state_dict's
    skipped list, key by key: every key of every ported family's model
    (mapped), a key at each of the converter's 22 skip sites and mapped
    keys of modules the port lacks."""
    from kgdet_tpu_torch.utils.convert import converter_skips
    from tests.test_torch_anchor import SSD300
    from tests.test_torch_anchor import family_cfg as anchor_cfg
    from tests.test_torch_dcn import dcn_cfg
    from tests.test_torch_serial import family_cfg
    from kgdet_tpu_torch.config import load_config
    state = dict(build_model(tiny_r50_cfg(), device='cpu').state_dict())
    cfgs = [family_cfg(t) for t in ('SerialKpHead', 'ParallelKpHead',
                                    'RepPointsHead', 'KGDetHead1Rep')]
    cfgs += [anchor_cfg('RetinaHead'), anchor_cfg('SSDHead'), dcn_cfg(),
             load_config(SSD300)]
    for cfg in cfgs:
        state.update(build_model(cfg, device='cpu').state_dict())
    for key in SKIPPED_KEYS + MAPPED_KEYS:
        state.setdefault(key, torch.zeros(4, 4, 3, 3))
    _, _, skipped = convert_state_dict(state)
    assert sorted(skipped) == sorted(SKIPPED_KEYS)
    assert [k for k in state if converter_skips(k)] == skipped
    # an HRFPN neck (a reduction_conv key) maps fpn_convs however named
    hrfpn = {'neck.reduction_conv.conv.weight': torch.zeros(4, 4, 1, 1),
             'neck.fpn_convs.0.foo.weight': torch.zeros(4, 4, 3, 3)}
    assert convert_state_dict(hrfpn)[2] == []
    assert not converter_skips('neck.fpn_convs.0.foo.weight', is_hrfpn=True)
    assert converter_skips('neck.fpn_convs.0.foo.weight')


def test_init_detector_takes_a_checkpoint_second(tmp_path):
    """The second positional argument is a checkpoint of the port, as in
    the JAX package's init_detector(config, checkpoint, pth): a .pth given
    there is not loaded as one (it holds no ``model`` entry), a params-only
    save of the port is."""
    from kgdet_tpu_torch.utils.checkpoint import save_params
    cfg = tiny_r50_cfg()
    path = tmp_path / 'model.pth'
    want = build_model(cfg, device='cpu').init_weights(1).state_dict()
    torch.save(want, path)
    with pytest.raises(KeyError, match='no model state_dict'):
        init_detector(cfg, str(path), device='cpu')
    save_params(str(tmp_path / 'ckpt'), want)
    for det in (init_detector(cfg, pth=str(path), device='cpu'),
                init_detector(cfg, str(tmp_path / 'ckpt'), device='cpu')):
        for k, v in det.model.state_dict().items():
            assert torch.equal(v, want[k])


def test_init_detector_defaults_to_the_card():
    """device=None means the CUDA card: without one init_detector raises
    and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        init_detector(tiny_r50_cfg())
    det = init_detector(tiny_r50_cfg(), device='cpu')
    assert next(det.model.parameters()).device.type == 'cpu'


CONFIG_FILES = sorted(os.path.basename(p) for p in
                      glob.glob(os.path.join(ROOT, 'configs', '*.py')))


@pytest.mark.parametrize('name', CONFIG_FILES)
def test_load_config_matches_jax_package(name):
    """The port's load_config runs the same config file against its own
    dataclasses: every field equals the JAX package's, no class of the JAX
    package is in the result, and sys.modules is as it was."""
    path = os.path.join(ROOT, 'configs', name)
    want = jload_config(path)
    before = {k: sys.modules.get(k) for k in ('kgdet_tpu', 'kgdet_tpu.config')}
    got = tconfig.load_config(path)
    after = {k: sys.modules.get(k) for k in ('kgdet_tpu', 'kgdet_tpu.config')}
    assert after == before and before['kgdet_tpu.config'] is not tconfig
    assert type(got) is tconfig.KGDetConfig
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if dataclasses.is_dataclass(v):
            assert type(v).__module__ == tconfig.__name__, f.name


def test_load_config_restores_sys_modules_on_error(tmp_path):
    """A config file that raises leaves sys.modules as it was."""
    bad = tmp_path / 'bad.py'
    bad.write_text('from kgdet_tpu.config import KGDetConfig\n'
                   'raise KeyError(1)\n')
    before = sys.modules['kgdet_tpu'], sys.modules['kgdet_tpu.config']
    with pytest.raises(KeyError):
        tconfig.load_config(str(bad))
    assert (sys.modules['kgdet_tpu'], sys.modules['kgdet_tpu.config']) \
        == before
    assert len(CONFIG_FILES) >= 17
