"""The port's small CLIs and public names (kgdet_tpu_torch: tools/coco_eval,
upgrade_model_version, visualize, get_flops, profile; models/layers.py::
ConvWS; models/families.py::register_head_family) against kgdet_tpu where
it has the same function, and against hand counts where it does not (the
JAX package's FLOPs come from XLA's cost analysis, another compiler)."""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

cv2 = pytest.importorskip('cv2')

from kgdet_tpu.eval.cocoeval import CocoEvaluator as JEvaluator
from kgdet_tpu.eval.coco import CocoIndex as JIndex
from kgdet_tpu.eval.json_writer import detections_to_json
from kgdet_tpu.models import families as jfamilies
from kgdet_tpu.models.layers import ConvWS as JConvWS
from kgdet_tpu.tools import visualize as jvisualize
from kgdet_tpu.tools.upgrade_model_version import \
    upgrade_state_dict as jupgrade
from kgdet_tpu_torch.models import families
from kgdet_tpu_torch.models.layers import ConvWS
from kgdet_tpu_torch.ops import deform_kernels as dk
from kgdet_tpu_torch.ops.kernel_cost import bottleneck_cost, sample_ops
from kgdet_tpu_torch.tools import coco_eval, get_flops, profile, \
    upgrade_model_version, visualize
from kgdet_tpu_torch.utils.convert import load_pth
from tests.test_torch_eval import _detections, make_eval_set, write_config

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def eval_set(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('tools'))
    ann = make_eval_set(d, n_images=4, landscape_only=True)
    return d, ann, write_config(d, ann)


def test_coco_eval_matches_the_jax_tool(eval_set, tmp_path, monkeypatch,
                                        capsys):
    """Both types from one results JSON each, --max-dets included: the
    printed summaries equal the JAX tool's, the stats its evaluator's."""
    from kgdet_tpu.tools import coco_eval as jcoco_eval
    _, ann, _ = eval_set
    with open(ann) as f:
        gt = json.load(f)
    dets, ids = _detections(gt, 'jittered')
    files = []
    cat_ids = sorted(c['id'] for c in gt['categories'])
    for kind, res in zip(('bbox', 'keypoints'),
                         detections_to_json(dets, ids, cat_ids)):
        files.append(str(tmp_path / f'r.{kind}.json'))
        with open(files[-1], 'w') as f:
            json.dump(res, f)
    # both types; then bbox alone with --max-dets (the keypoint summary
    # reads max_dets 20, which both packages then refuse)
    for types, extra in ((('bbox', 'keypoints'), []),
                         (('bbox',), ['--max-dets', '1', '5', '50'])):
        args = ['--result', *files[:len(types)], '--ann', ann, '--types',
                *types] + extra
        got = coco_eval.main(args)
        printed = capsys.readouterr().out
        monkeypatch.setattr(sys, 'argv', ['coco_eval'] + args)
        jcoco_eval.main()
        assert printed == capsys.readouterr().out
        gt_index = JIndex(ann)
        assert list(got) == list(types)
        for res, kind in zip(files, types):
            ev = JEvaluator(gt_index, gt_index.load_results(res), kind)
            if extra:
                ev.params.max_dets = [1, 5, 50]
            ev.evaluate()
            ev.accumulate()
            want = ev.summarize(verbose=False)
            assert list(got[kind]) == list(want)
            np.testing.assert_allclose(list(got[kind].values()),
                                       list(want.values()), rtol=1e-12)
            assert 0 < want['AP'] < 1


def test_upgrade_model_version_renames_and_loads(tmp_path):
    """The keys and count of tests/test_convert.py::
    test_upgrade_model_version_renames, then the CLI's file through
    load_pth, its meta kept."""
    state = {
        'bbox_head.cls_convs.0.weight': torch.zeros(1),
        'bbox_head.cls_convs.0.bias': torch.zeros(1),
        'bbox_head.reg_convs.2.weight': torch.ones(1),
        'bbox_head.cls_convs.0.gn.weight': torch.zeros(1),
        'backbone.conv1.weight': torch.zeros(1),
    }
    got, n = upgrade_model_version.upgrade_state_dict(state)
    want, jn = jupgrade(state)
    assert n == jn == 3 and list(got) == list(want)
    src, dst = str(tmp_path / 'old.pth'), str(tmp_path / 'new.pth')
    torch.save({'state_dict': {f'module.{k}': v for k, v in state.items()},
                'meta': {'epoch': 12}}, src)
    assert upgrade_model_version.main([src, dst]) == 3
    loaded = load_pth(dst)
    assert sorted(loaded) == sorted(want)
    assert loaded['bbox_head.reg_convs.2.conv.weight'].item() == 1.0
    assert torch.load(dst, weights_only=False)['meta'] == {'epoch': 12}


def test_visualize_draws_as_the_jax_tool(eval_set, tmp_path):
    """draw_detections bit for bit against the JAX one on the same
    detections (boxes under the threshold, labels past the class names,
    invisible keypoints); then the CLI on the CPU writes what
    draw_detections makes of the port Detector's detections."""
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (90, 120, 3), np.uint8)
    n = 6
    xy = rng.uniform(0, 80, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2)),
                            rng.rand(n, 1)], 1).astype(np.float32)
    labels = np.array([0, 3, 12, 13, 20, 5])
    kpts = np.concatenate([rng.uniform(0, 100, (n, 4, 2)),
                           rng.randint(0, 3, (n, 4, 1))], -1)
    for thr in (0.0, 0.5):
        got = visualize.draw_detections(img, boxes, labels, kpts, thr)
        want = jvisualize.draw_detections(img, boxes, labels, kpts, thr)
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)
    d, _, cfg_path = eval_set
    image, out = f'{d}/img_000.png', str(tmp_path / 'vis.png')
    drawn, n_drawn = visualize.main([cfg_path, image, '--out', out,
                                     '--score-thr', '0.0', '--device',
                                     'cpu'])
    from kgdet_tpu_torch.api import init_detector
    src = cv2.imread(image)
    boxes, labels, kpts = init_detector(cfg_path, device='cpu')(src)
    np.testing.assert_array_equal(
        drawn, jvisualize.draw_detections(src, boxes, labels, kpts, 0.0))
    np.testing.assert_array_equal(cv2.imread(out), drawn)
    assert n_drawn == len(boxes) > 0


@pytest.mark.parametrize('stride,padding', [(1, 'SAME'), (2, 'SAME'),
                                            (1, 1)])
def test_conv_ws_matches_jax(stride, padding):
    x = np.random.RandomState(0).randn(2, 9, 11, 5).astype(np.float32)
    jm = JConvWS(features=7, strides=stride, padding=padding)
    params = dict(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))['params'])
    params['bias'] = jnp.asarray(np.random.RandomState(1).randn(7),
                                 jnp.float32)
    want = np.asarray(jm.apply({'params': params}, jnp.asarray(x)))
    tm = ConvWS(5, 7, stride=stride, padding=padding)
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(np.transpose(
            np.array(params['kernel']), (3, 2, 0, 1))))
        tm.bias.copy_(torch.from_numpy(np.array(params['bias'])))
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    assert sorted(dict(tm.named_parameters())) == ['bias', 'weight']


def test_register_head_family():
    assert sorted(families.HEAD_FAMILIES) == sorted(jfamilies.HEAD_FAMILIES)
    rec = families.HeadFamily(build=None, loss=None, make_decode=None)
    try:
        families.register_head_family('ToyHead', rec)
        assert families.get_head_family('ToyHead') is rec
        for name in ('ToyHead', 'KGDetHead'):
            with pytest.raises(KeyError, match='already registered'):
                families.register_head_family(name, rec)
    finally:
        families.HEAD_FAMILIES.pop('ToyHead', None)
    assert 'ToyHead' not in families.HEAD_FAMILIES


class _Toy(nn.Module):
    """A 3x3 conv, one K1 call on its map, a linear layer."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.conv = nn.Conv2d(3, 8, 3, padding=1)
        self.w = nn.Parameter(torch.randn(9, 8, 4, generator=g))
        self.fc = nn.Linear(4, 2)
        self.pos = torch.rand(1, 64, 9, 2, generator=g) * 7

    def forward(self, x):
        y = self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.fc(dk.deform_conv_fused(y, self.pos, self.w))


def test_flops_are_library_ops_plus_kernel_formulas():
    """A hand count: the conv and the linear layer as FlopCounterMode counts
    them, K1 by its formula (its plain version's einsum not counted)."""
    lib, kernels = get_flops.count_forward(_Toy(), torch.zeros(1, 8, 8, 3))
    assert lib == 2 * 64 * 8 * 27 + 2 * 64 * 4 * 2
    k1 = kernels.kernels['K1 deform_conv_fused']
    assert k1['calls'] == 1 and list(kernels.kernels) == [
        'K1 deform_conv_fused']
    assert k1['flops'] == 2 * 64 * 9 * 8 * 4 + sample_ops(64 * 9 * 8)
    assert k1['bytes'] == 4 * (64 * 8 + 64 * 9 * 2 + 9 * 8 * 4 + 64 * 4)


def test_get_flops_on_the_tiny_cascade(eval_set, monkeypatch, capsys):
    """The tiny R-50 cascade: the parameter count and the padded shape
    equal the JAX tool's, the kernels the forward runs (K1 x12 at the
    stride-32 map, K4, K5 x3, K10 x39 with no operation) counted by their
    formulas."""
    from kgdet_tpu.tools import get_flops as jget_flops
    _, _, cfg_path = eval_set
    out = get_flops.main([cfg_path, '--shape', '60', '90', '--device',
                          'cpu'])
    printed = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, 'argv', ['get_flops', cfg_path, '--shape',
                                      '60', '90'])
    jget_flops.main()
    jprinted = capsys.readouterr().out.splitlines()
    assert printed[:2] == jprinted[:2]          # input shape, params
    from kgdet_tpu.api import build_model as jbuild_model
    from kgdet_tpu.api import init_variables
    from kgdet_tpu.config import load_config as jload_config
    jcfg = jload_config(cfg_path)
    variables = init_variables(jbuild_model(jcfg), jcfg,
                               canvas_hw=(64, 96))
    assert out['params'] == sum(p.size for p in
                                jax.tree.leaves(variables['params']))
    assert out['shape'] == (1, 64, 96, 3)
    calls = {k: v['calls'] for k, v in out['kernels'].items()}
    assert calls == {'K1 deform_conv_fused': 12, 'K4 stem_pool': 1,
                     'K5 frozen_bottleneck': 3, 'K10 bn_epilogue': 39}
    assert out['kernels']['K10 bn_epilogue']['flops'] == 0
    # K1 on the 2x3 stride-32 map: t = 9 / 25 / 49, C = F = 64, 4 calls
    # each (2 deformable stages x 2 branches)
    P, C = 6, 64
    k1 = sum(4 * (2 * P * t * C * C + sample_ops(P * t * C))
             for t in (9, 25, 49))
    assert out['kernels']['K1 deform_conv_fused']['flops'] == k1
    blocks = [bottleneck_cost(torch.zeros(1, 16, 24, cin), *[torch.zeros(
        s) for s in ((cin, 64), (64,), (3, 3, 64, 64), (64,), (64, 256),
                     (256,))], *((torch.zeros(cin, 256), torch.zeros(256))
                                 if cin == 64 else ()))[0]
              for cin in (64, 256, 256)]
    assert out['kernels']['K5 frozen_bottleneck']['flops'] == sum(blocks)
    assert out['kernels']['K4 stem_pool']['flops'] == \
        2 * 32 * 48 * 64 * 147
    assert out['flops'] == out['library_flops'] + out['kernel_flops']
    assert any(ln.startswith('bytes (port kernels): ') for ln in printed)


@pytest.mark.parametrize('mode,names', [
    ('infer', ('K1 deform_conv_fused', 'K4 stem_pool',
               'K5 frozen_bottleneck', 'K9 greedy_nms', 'aten::conv2d',
               'kgdet.predict', 'kgdet.forward', 'kgdet.backbone',
               'kgdet.decode')),
    ('train', ('K2 deform_sample_split', 'K3 deform_sample_bwd',
               'K4 stem_pool', 'K5 frozen_bottleneck', 'aten::conv2d',
               'kgdet.step', 'kgdet.loss', 'kgdet.backward',
               'kgdet.optimizer'))])
def test_profile_writes_a_trace_naming_the_kernels(eval_set, tmp_path, mode,
                                                  names):
    _, _, cfg_path = eval_set
    path = profile.main([cfg_path, '--mode', mode, '--steps', '1',
                         '--batch-size', '2', '--trace-dir',
                         str(tmp_path), '--device', 'cpu'])
    with open(path) as f:
        events = json.load(f)['traceEvents']
    seen = {e.get('name') for e in events}
    for name in names:
        assert name in seen, (mode, name)
