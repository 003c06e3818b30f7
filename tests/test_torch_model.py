"""The port's serving path (kgdet_tpu_torch) against kgdet_tpu, whole.

One tiny KGDet model (R-50 with frozen_stages=1, FPN at 64 channels with
select_out=(2,), a 64-channel head with one tower conv, 12 keypoints and
8 GN groups) is initialized by the JAX package, its variables are carried
into the port through ``state_dict_from_jax``, and both run the same inputs
on the CPU. Tolerances: 1e-4 on head outputs and 5e-4 on the moment boxes
(tests/test_reference_parity.py); 1e-3 on decoded detections.
"""
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
from kgdet_tpu_torch.api import Detector, build_model, make_predict_fn
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
    port = build_model(cfg)
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
    cfg = tiny_r50_cfg().replace(detector_type='faster_rcnn')
    with pytest.raises(NotImplementedError, match='Queue 1'):
        build_model(cfg)
    cfg = tiny_r50_cfg()
    cfg = cfg.replace(head=cfg.head.__class__(type='RetinaHead'))
    with pytest.raises(NotImplementedError, match='Queue 1'):
        build_model(cfg)


def test_port_runs_without_jax_flax_cv2():
    """The port imports and serves with jax, flax and cv2 unavailable, as
    on the GPU machine."""
    code = '\n'.join([
        'import sys',
        "for m in ('jax', 'flax', 'cv2'):",
        '    sys.modules[m] = None',
        'import numpy as np, torch',
        'torch.set_num_threads(1)',
        'from kgdet_tpu.config import (BackboneConfig, HeadConfig, '
        'KGDetConfig, NeckConfig, TestConfig)',
        'from kgdet_tpu_torch.api import build_model, make_predict_fn',
        'cfg = KGDetConfig(backbone=BackboneConfig(depth=50, '
        'frozen_stages=1), neck=NeckConfig(out_channels=64), '
        'head=HeadConfig(in_channels=64, feat_channels=64, '
        'stacked_convs=1, num_keypts=12, gn_groups=8), '
        'test=TestConfig(nms_pre=50, max_per_class=10, max_per_img=20, '
        'score_thr=0.0))',
        'model = build_model(cfg).init_weights(0).eval()',
        'rng = np.random.RandomState(0)',
        "batch = {'image': rng.randint(0, 256, (1, 64, 96, 3))"
        ".astype(np.uint8), 'img_hw': np.array([[64, 96]], np.float32),"
        " 'scale_factor': np.ones(1, np.float32)}",
        'dets = make_predict_fn(model, cfg, (64, 96))(batch)',
        "assert dets['valid'].any()",
        "print('ok', sorted(k for k in sys.modules if k.startswith("
        "('jax', 'flax', 'cv2')) and sys.modules[k] is not None))",
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
    from kgdet_tpu_torch.api import init_detector
    cfg, _, variables, port = models
    state = _flax_to_torch_state(variables)
    for k in [k for k in state if k.endswith('.running_mean')]:
        state[k[:-len('running_mean')] + 'num_batches_tracked'] = \
            torch.tensor(7)
    path = tmp_path / 'kgdet.pth'
    torch.save({'state_dict': {'module.' + k: v for k, v in state.items()}},
               path)
    det = init_detector(cfg, pth=str(path))
    batch = _batch(seed=3)
    want = make_predict_fn(port, cfg, CANVAS)(batch)
    got = det._predict_for(CANVAS)(batch)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
