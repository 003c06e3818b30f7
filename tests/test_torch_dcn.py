"""The DCN backbone of the port (kgdet_tpu_torch/models/resnet.py:
``DeformConv3x3``, ``Bottleneck(use_dcn=True)``, ``ResNet(dcn_stages)``)
against kgdet_tpu.

On the CPU the deformable sampling runs the plain version of K6 and K3
(ops/deform.py::bilinear_gather under autograd) in both packages. Seeded
NumPy inputs, the same weights through ``utils/convert.py::
state_dict_from_jax``, f32: a stride-2 DCN with zero offsets equals the
3x3/2 conv; a DCN block's output and every gradient (input, offset conv,
DCN weight, the other convs and norms) at strides 1 and 2 within 1e-5 of
scale; the tiny cascade with ``dcn_stages=(1, 2, 3)`` (offsets of a
fraction of a cell): head outputs, detections, the loss and every
parameter's gradient by the whole-model rule (1e-3 of scale in all but 1%
of the elements, 5e-2 in all); the DCN converter names both ways and the
``.pth`` route's accepts and refusals; the tap-major weight kept while
serving. Tolerances are stated at each assert.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.api import make_predict_fn as jmake_predict_fn
from kgdet_tpu.models.detector import build_backbone as jbuild_backbone
from kgdet_tpu.models.resnet import Bottleneck as JBottleneck
from kgdet_tpu.ops.deform import deform_conv as jdeform_conv
from kgdet_tpu.parallel import train as jtrain
from kgdet_tpu.utils.torch_convert import (convert_state_dict,
                                           merge_into_variables)
from kgdet_tpu_torch.api import build_model, make_predict_fn
from kgdet_tpu_torch.models.detector import build_backbone
import kgdet_tpu_torch.models.resnet as resnet_mod
from kgdet_tpu_torch.models.resnet import Bottleneck, DeformConv3x3, ResNet
from kgdet_tpu_torch.ops import plain_kernels, runs_kernel
from kgdet_tpu_torch.ops.deform import deform_conv
from kgdet_tpu_torch.parallel import train as ttrain
from kgdet_tpu_torch.utils.convert import (load_reference_state,
                                           state_dict_from_jax)
from tests.common import synth_batch
from tests.test_torch_model import _perturb, tiny_r50_cfg

torch.set_num_threads(1)
CANVAS = (64, 96)
# offset conv weights of this std give offsets of a few hundredths of a
# cell on the perturbed tiny model. Larger ones make every DCN block a
# strong amplifier of its input's f32 rounding (through the offsets, the
# sampling positions and the maps' steep spatial gradients): at 0.003 the
# two packages' C5 differ by 2e-4 of its scale, enough to flip a few ReLUs
# of layer4's 12 pixels a channel.
OFFSET_STD = 3e-4
MODEL_F32_REL, MODEL_GRAD_REL, MODEL_FLIP_SHARE = 1e-3, 5e-2, 1e-2


def _np(t):
    return t.detach().numpy()


def _base_grid():
    return np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], indexing='ij'),
                    axis=-1).reshape(9, 2).astype(np.float32)


def test_stride2_zero_offsets_equal_a_3x3_stride2_conv():
    """tests/test_dcn.py's case in the port: with zero offsets the
    stride-2 DCN is the plain 3x3/2 conv (pad 1), and equals the JAX
    deform_conv; 1e-4."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 11, 4).astype(np.float32)
    w_hwio = rng.randn(3, 3, 4, 6).astype(np.float32)
    w_taps = w_hwio.reshape(9, 4, 6)
    rel = np.broadcast_to(_base_grid(), (2, 5, 6, 9, 2)).copy()
    got = deform_conv(torch.from_numpy(x), torch.from_numpy(rel),
                      torch.from_numpy(w_taps), stride=2)
    want = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                    torch.from_numpy(w_hwio).permute(3, 2, 0, 1), stride=2,
                    padding=1).permute(0, 2, 3, 1)
    assert got.shape == (2, 5, 6, 6)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)
    jgot = jdeform_conv(jnp.asarray(x), jnp.asarray(rel),
                        jnp.asarray(w_taps), stride=2)
    np.testing.assert_allclose(_np(got), np.asarray(jgot), atol=1e-5)
    # the module on zero offsets: the same function
    conv = DeformConv3x3(4, 6, stride=2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w_hwio).permute(3, 2, 0, 1))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.zeros(2, 18, 5, 6))
    np.testing.assert_allclose(_np(got), _np(want.permute(0, 3, 1, 2)),
                               atol=1e-4)


def _block_variables(stride, seed):
    """A JAX DCN Bottleneck (planes 8, Cin 16, downsample) with random BN
    statistics and an offset conv that moves taps by about a cell."""
    rng = np.random.RandomState(seed)
    jblock = JBottleneck(planes=8, stride=stride, downsample=True,
                         use_dcn=True)
    x = rng.randn(2, 9, 11, 16).astype(np.float32)
    variables = jblock.init(jax.random.PRNGKey(seed), jnp.asarray(x))

    def f(path, v):
        keys = [getattr(p, 'key', str(p)) for p in path]
        v = np.asarray(v)
        if 'conv_offset' in keys:
            return (rng.randn(*v.shape) * 0.3).astype(np.float32)
        if keys[-1] == 'mean':
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        if keys[-1] == 'var':
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return v
    return jblock, jax.tree_util.tree_map_with_path(f, variables), x, rng


def _as_block_state(variables):
    state = state_dict_from_jax(
        {'params': {'backbone': {'layer2/0': variables['params']}},
         'batch_stats': {'backbone': {'layer2/0':
                                      variables['batch_stats']}}})
    return {k[len('backbone.layer2.0.'):]: v for k, v in state.items()}


@pytest.mark.parametrize('stride', [1, 2])
def test_dcn_block_output_and_gradients_match_jax(stride):
    """Bottleneck(use_dcn=True) against the JAX block: output, the input's
    gradient and every parameter's (the offset conv's through the
    sampling's position gradient, the tap-major DCN weight's), f32, within
    1e-5 of each one's scale."""
    jblock, variables, x, rng = _block_variables(stride, seed=stride)
    Ho, Wo = -(-9 // stride), -(-11 // stride)
    ct = rng.randn(2, Ho, Wo, 32).astype(np.float32)

    def jloss(params, xin):
        out = jblock.apply({'params': params,
                            'batch_stats': variables['batch_stats']}, xin)
        return jnp.sum(out * ct), out
    (_, jout), (jg_params, jg_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables['params'],
                                              jnp.asarray(x))

    blk = Bottleneck(16, 8, stride, downsample=True, use_dcn=True)
    blk.load_state_dict(_as_block_state(variables), strict=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = blk(xt)
    (out * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=what,
                                   atol=1e-5 * np.abs(want).max())
    assert out.shape == (2, 32, Ho, Wo)
    close(_np(out.permute(0, 2, 3, 1)), jout, 'output')
    close(_np(xt.grad.permute(0, 2, 3, 1)), jg_x, 'grad x')
    jg = _as_block_state({'params': jg_params,
                          'batch_stats': variables['batch_stats']})
    grads = {n: p.grad for n, p in blk.named_parameters()}
    assert sorted(grads) == sorted(k for k in jg if not k.endswith(
        ('running_mean', 'running_var', 'num_batches_tracked')))
    for name, g in grads.items():
        close(_np(g), jg[name], name)
    assert np.abs(_np(grads['conv2_offset.weight'])).max() > 0


def dcn_cfg():
    cfg = tiny_r50_cfg()
    return cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                    dcn_stages=(1, 2, 3)))


def _offsets(variables):
    rng = np.random.RandomState(1)

    def f(path, v):
        keys = [getattr(p, 'key', str(p)) for p in path]
        if 'conv_offset' in keys:
            return (rng.randn(*np.shape(v)) * OFFSET_STD).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(f, variables)


@pytest.fixture(scope='module')
def cascade():
    cfg = dcn_cfg()
    jmodel = jbuild_model(cfg)
    variables = _offsets(_perturb(init_variables(jmodel, cfg,
                                                 canvas_hw=CANVAS)))
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
    tgrads = {k: v.grad for k, v in model.named_parameters()}
    jg = {k: v.numpy() for k, v in
          state_dict_from_jax({'params': jgrads}).items()}
    return dict(cfg=cfg, jmodel=jmodel, variables=variables,
                model=model.eval(), jlogs={k: float(v) for k, v in
                                           jlogs.items()},
                logs={k: v.item() for k, v in logs.items()},
                jtotal=float(jtotal), total=total.item(), jgrads=jg,
                tgrads=tgrads)


def test_cascade_with_dcn_builds_the_reference_names(cascade):
    """13 DCN blocks (layer2-4) with the reference's names, the offset
    convs zero-initialized by init_weights, layer1 on the frozen prefix."""
    model = build_model(dcn_cfg(), device='cpu').init_weights(0)
    names = dict(model.named_parameters())
    dcn = [n for n in names if n.endswith('conv2_offset.weight')]
    assert len(dcn) == 13 and all(n.startswith(('backbone.layer2.',
                                                'backbone.layer3.',
                                                'backbone.layer4.'))
                                  for n in dcn)
    for n in dcn:
        block = n[:-len('conv2_offset.weight')]
        assert names[block + 'conv2.weight'].shape[2:] == (3, 3)
        assert not names[n].any() and not names[block
                                                + 'conv2_offset.bias'].any()
        assert names[block + 'conv2.weight'].std() > 0
    assert isinstance(model.backbone.layer2[0].conv2, DeformConv3x3)
    assert model.backbone.layer2[0].conv2.stride == 2
    assert not hasattr(model.backbone.layer1[0], 'conv2_offset')


def test_cascade_head_outputs_and_detections_match_jax(cascade):
    """Head outputs of the DCN cascade within 1e-3 of each map's scale (the
    DCN stages carry the backbone's f32 rounding into the sampling
    positions); served detections: labels and valid equal, boxes within
    1e-3 relative and 1e-2 px."""
    cfg, model = cascade['cfg'], cascade['model']
    img = np.random.RandomState(3).randn(2, *CANVAS, 3).astype(np.float32)
    want = jax.jit(cascade['jmodel'].apply)(cascade['variables'],
                                            jnp.asarray(img))
    with torch.no_grad():
        got = model(torch.from_numpy(img))
    for k in ('cls', 'kpt', 'bbox'):
        w = np.asarray(want[0][k])
        np.testing.assert_allclose(_np(got[0][k]), w, rtol=MODEL_F32_REL,
                                   atol=MODEL_F32_REL * np.abs(w).max(),
                                   err_msg=k)
    rng = np.random.RandomState(4)
    batch = {'image': rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8),
             'img_hw': np.asarray([[64, 96], [56, 80]], np.float32),
             'scale_factor': np.asarray([1.0, 0.75], np.float32)}
    jd = jmake_predict_fn(cascade['jmodel'], cfg, CANVAS)(
        cascade['variables'], {k: jnp.asarray(v) for k, v in batch.items()})
    td = make_predict_fn(model, cfg, CANVAS)(batch)
    assert np.asarray(jd['valid']).sum() > 0
    for k in ('valid', 'det_labels'):
        np.testing.assert_array_equal(_np(td[k]), np.asarray(jd[k]))
    for k in ('det_bboxes', 'det_kpts'):
        np.testing.assert_allclose(_np(td[k]), np.asarray(jd[k]), rtol=1e-3,
                                   atol=1e-2, err_msg=k)


def test_cascade_loss_and_gradients_by_the_whole_model_rule(cascade):
    """The loss and its terms within 1e-4 relative; every parameter's
    gradient within MODEL_GRAD_REL of its scale in every element and
    MODEL_F32_REL in all but MODEL_FLIP_SHARE of the elements (the DCN
    offset convs included, reached through the sampling's position
    gradient); the frozen prefix has none in the port, a zero one in JAX."""
    np.testing.assert_allclose(cascade['total'], cascade['jtotal'],
                               rtol=1e-4)
    for k, v in cascade['jlogs'].items():
        np.testing.assert_allclose(cascade['logs'][k], v, rtol=1e-4,
                                   err_msg=k)
    beyond = total = 0
    for name, want in cascade['jgrads'].items():
        got = cascade['tgrads'][name]
        if got is None:
            assert not want.any(), name
            continue
        diff = np.abs(_np(got) - want) / np.abs(want).max()
        assert diff.max() <= MODEL_GRAD_REL, (name, diff.max())
        beyond += int((diff > MODEL_F32_REL).sum())
        total += diff.size
    assert beyond <= MODEL_FLIP_SHARE * total, beyond / total
    for name in ('backbone.layer2.0.conv2_offset.weight',
                 'backbone.layer4.2.conv2.weight'):
        assert np.abs(cascade['jgrads'][name]).max() > 0, name
        assert cascade['tgrads'][name] is not None, name


def test_dcn_converter_names_both_ways(cascade):
    """state_dict_from_jax names a DCN block's offset conv
    ``conv2_offset.{weight,bias}`` and its weight ``conv2.weight`` in OIHW
    (tap k at (k // 3, k % 3)); the port's state_dict goes back through
    torch_convert with nothing skipped, every leaf as it was."""
    variables = cascade['variables']
    state = state_dict_from_jax(variables)
    jblk = variables['params']['backbone']['layer3/0']['conv2']
    np.testing.assert_array_equal(
        state['backbone.layer3.0.conv2_offset.weight'].numpy(),
        np.transpose(np.asarray(jblk['conv_offset']['kernel']),
                     (3, 2, 0, 1)))
    w = state['backbone.layer3.0.conv2.weight'].numpy()
    for k in range(9):
        np.testing.assert_array_equal(np.asarray(jblk['weight'])[k],
                                      w[:, :, k // 3, k % 3].T)
    params, stats, skipped = convert_state_dict(
        cascade['model'].state_dict())
    assert skipped == []
    merged = merge_into_variables(variables, params, stats, strict=True)
    flat = jax.tree_util.tree_flatten_with_path
    assert len(flat(params)[0]) + len(flat(stats)[0]) == \
        len(flat(variables)[0])
    for (pa, a), (pb, b) in zip(flat(merged)[0], flat(variables)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dcn_pth_route_accepts_and_refuses_as_jax(cascade):
    """load_reference_state on DCN keys, case by case against
    convert_state_dict + merge_into_variables(strict=True): a DCN state
    into the DCN model loads; a block's conv2.weight without its
    conv2_offset (the converter's plain-conv layout) into a DCN block, and
    a conv2_offset into a plain block, raise KeyError; an offset conv of
    another shape raises ValueError."""
    model, variables = cascade['model'], cascade['variables']
    state = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = build_model(dcn_cfg(), device='cpu')
    assert load_reference_state(fresh, state) == []
    for k, v in state.items():
        assert torch.equal(fresh.state_dict()[k], v), k
    plain_vars = init_variables(jbuild_model(tiny_r50_cfg()),
                                tiny_r50_cfg(), canvas_hw=CANVAS)
    plain = build_model(tiny_r50_cfg(), device='cpu')
    key = 'backbone.layer2.1.conv2'
    cases = [
        (fresh, variables, {key + '.weight': state[key + '.weight']},
         KeyError),
        (plain, plain_vars, {key + '_offset.weight':
                             state[key + '_offset.weight'],
                             key + '_offset.bias': state[key + '_offset.bias'],
                             key + '.weight': state[key + '.weight']},
         KeyError),
        (fresh, variables, {key + '_offset.weight': torch.zeros(18, 128, 1, 1),
                            key + '.weight': state[key + '.weight']},
         ValueError),
    ]
    for target, tvars, bad, err in cases:
        with pytest.raises(err):
            load_reference_state(target, bad)
        params, stats, _ = convert_state_dict(bad)
        with pytest.raises(err):
            merge_into_variables(tvars, params, stats, strict=True)
    # with its offset conv, the block's conv2 loads
    ok = {k: state[k] for k in (key + '_offset.weight', key + '_offset.bias',
                                key + '.weight')}
    assert load_reference_state(fresh, ok) == []


def test_dcn_plain_switch_prefix_and_refusals(monkeypatch):
    """plain_kernels() reaches the DCN blocks; a DCN in stage 0 runs the
    stem and layer1 without the frozen prefix (and equals the prefix route
    with zero offsets); the DCN backbone with grouped DCN (ResNeXt widths,
    groups 32), with the context block in stage 1, or in caffe style builds
    and its stage outputs match the JAX backbone's within 1e-4 of scale
    (the JAX variables loaded with strict names)."""
    cfg = dcn_cfg()
    model = build_model(cfg, device='cpu').init_weights(0)
    blocks = [m for m in model.modules() if isinstance(m, DeformConv3x3)]
    assert len(blocks) == 13
    seen, real = [], resnet_mod.deform_conv
    card = torch.empty(0, device='meta')

    def recording(*a, **k):
        seen.append(runs_kernel(card))
        return real(*a, **k)
    monkeypatch.setattr(resnet_mod, 'deform_conv', recording)
    with torch.no_grad():
        for plain in (True, False):
            with plain_kernels(plain):
                for b in blocks:
                    s = b.stride
                    b(torch.zeros(1, b.weight.shape[1], 3, 4),
                      torch.zeros(1, 18, -(-3 // s), -(-4 // s)))
    assert seen == [False] * 13 + [True] * 13

    net0 = ResNet(depth=50, frozen_stages=1, dcn_stages=(0, 1))
    net1 = ResNet(depth=50, frozen_stages=1, dcn_stages=(1,))
    net0.init_weights(torch.Generator().manual_seed(2))
    state = net0.state_dict()
    net1.load_state_dict({k: v for k, v in state.items()
                          if not k.startswith('layer1.')
                          or 'conv2_offset' not in k}, strict=True)
    x = torch.from_numpy(np.random.RandomState(5).randn(
        1, 64, 96, 3).astype(np.float32))
    calls = []
    net0.frozen_prefix = lambda *a: calls.append(a)
    with torch.no_grad():
        got, want = net0(x), net1(x)
    assert calls == []
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item())
    x = np.random.RandomState(6).randn(1, 32, 32, 3).astype(np.float32)
    for kw in ({'groups': 32}, {'gcb_stages': (1,)}, {'style': 'caffe'}):
        bcfg = dataclasses.replace(cfg.backbone, **kw)
        jnet = jbuild_backbone(cfg.replace(backbone=bcfg), jnp.float32)
        variables = _offsets(_perturb(dict(jax.jit(jnet.init)(
            jax.random.PRNGKey(0), jnp.asarray(x)))))
        net = build_backbone(bcfg)
        state = state_dict_from_jax({k: {'backbone': v}
                                     for k, v in variables.items()})
        net.load_state_dict({k[len('backbone.'):]: v
                             for k, v in state.items()}, strict=True)
        with torch.no_grad():
            got = net(torch.from_numpy(x))
        want = jax.jit(jnet.apply)(variables, jnp.asarray(x))
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(_np(g.permute(0, 2, 3, 1)), w,
                                       rtol=1e-4, err_msg=str(kw),
                                       atol=1e-4 * np.abs(w).max())


def test_dcn_tap_major_weight_kept_while_serving():
    """The DCN weight's tap-major copy is made once while the block serves
    (eval, no gradient) and dropped by load_state_dict; under training it
    is made anew and differentiable."""
    blk = Bottleneck(16, 8, 2, downsample=True, use_dcn=True)
    ResNet.init_weights(blk, torch.Generator().manual_seed(1))
    conv = blk.conv2
    x = torch.randn(1, 16, 9, 11)
    blk.eval()
    with torch.no_grad():
        first = conv.tap_major(torch.float32)
        assert conv.tap_major(torch.float32) is first
        out = blk(x)
        assert conv.tap_major(torch.float32) is first
    blk.load_state_dict(blk.state_dict())
    with torch.no_grad():
        assert conv.tap_major(torch.float32) is not first
        torch.testing.assert_close(blk(x), out, rtol=0, atol=0)
    blk.train()
    w = conv.tap_major(torch.float32)
    assert w.requires_grad and w.shape == (9, 8, 8)
