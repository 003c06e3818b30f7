"""The backbone and neck extras of the port (kgdet_tpu_torch: caffe style,
BasicBlock depths, ResNeXt and its grouped DCN in models/resnet.py,
models/plugins.py, models/necks_extra.py, the registries of
models/detector.py) against kgdet_tpu; HRNet and the four two-stage
configs' backbones and necks are in tests/test_torch_two_stage_backbones.py.

Each module is built from the same config in both packages and given the
same weights (flax variables carried into the port through
``utils/convert.py::state_dict_from_jax``), with random BatchNorm
statistics and the zero-initialized plugin outputs and DCN offset convs
made non-zero so that every part contributes. On seeded NumPy inputs, f32:
every output map within 1e-4 of its scale, and the gradient of a fixed
random projection of the outputs with respect to every parameter by the
whole-model rule of ROADMAP "Standing findings" (1e-3 of scale in all but
1% of the elements, 5e-2 in all); the state-dict round trips through the
JAX converter and the ``.pth`` routes. Tolerances are stated at each
assert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from kgdet_tpu.config import BackboneConfig, KGDetConfig, NeckConfig
from kgdet_tpu.models import plugins as jplugins
from kgdet_tpu.models.detector import build_backbone as jbuild_backbone
from kgdet_tpu.models.detector import build_neck as jbuild_neck
from kgdet_tpu.models.necks_extra import HRFPN as JHRFPN
from kgdet_tpu.utils.torch_convert import (convert_state_dict,
                                           merge_into_variables)
from kgdet_tpu_torch.models import plugins
from kgdet_tpu_torch.models.detector import build_backbone, build_neck
from kgdet_tpu_torch.models.necks_extra import HRFPN
from kgdet_tpu_torch.models.resnet import BasicBlock, DeformConv3x3, \
    ResNeXt
from kgdet_tpu_torch.utils.convert import (load_reference_state,
                                           state_dict_from_jax)

torch.set_num_threads(1)
CANVAS = (64, 96)
OUT_REL = 1e-4
MODEL_F32_REL, MODEL_GRAD_REL, MODEL_FLIP_SHARE = 1e-3, 5e-2, 1e-2
# the zero-initialized parameters (plugin outputs, DCN offset convs) get
# values of this scale; small offsets keep the DCN blocks from amplifying
# the packages' f32 rounding (tests/test_torch_dcn.py, OFFSET_STD)
OFFSET_STD, PLUGIN_STD = 3e-4, 0.05
# a gradient that is zero in exact arithmetic (a bias ahead of a softmax,
# which is invariant to the shift it makes: the non-local block's theta /
# phi biases, the context block's conv_mask bias) holds rounding only, and
# is held against this share of the largest gradient of the module
GRAD_FLOOR = 1e-3


def _np(t):
    return t.detach().numpy()


def _perturb(variables, seed=0):
    """Random BN statistics; non-zero values for the parameters that start
    at zero (DCN offsets, plugin outputs, gamma)."""
    rng = np.random.RandomState(seed)

    def f(path, v):
        keys = [getattr(p, 'key', str(p)) for p in path]
        v = np.asarray(v)
        if keys[-1] == 'mean':
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        if keys[-1] == 'var':
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if 'nonlocal_block' in keys and keys[-2] in ('theta', 'phi') \
                and keys[-1] == 'kernel':
            # attention logits of order one on a backbone's maps of order
            # 1e2 (random BN statistics), where a one-hot softmax would
            # turn f32 rounding of its logits into 1e-3 of its output
            return v * 1e-2
        if not v.any() and v.size > 1 or keys[-1] == 'gamma':
            std = OFFSET_STD if 'conv_offset' in keys else PLUGIN_STD
            return (rng.randn(*v.shape) * std).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(f, variables)


class Wrapped(nn.Module):
    """A port backbone or neck under the detector's attribute name, so its
    state_dict carries the reference's full names."""

    def __init__(self, part, name):
        super().__init__()
        self.add_module(name, part)


def _pair(jmodule, tmodule, comp, inputs, seed=0):
    """JAX variables for ``jmodule`` (perturbed) and the port module
    loaded with them; ``comp``: 'backbone' or 'neck'."""
    variables = dict(jax.jit(jmodule.init)(jax.random.PRNGKey(seed),
                                           inputs))
    variables = _perturb(variables, seed)
    wrapped = {k: {comp: v} for k, v in variables.items() if v}
    state = state_dict_from_jax(wrapped)
    Wrapped(tmodule, comp).load_state_dict(state, strict=True)
    return variables, wrapped


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _check_forward_and_grads(jmodule, tmodule, variables, comp, jin, tin,
                             seed=1):
    """Outputs within OUT_REL of each map's scale; the gradients of
    sum(out_i * R_i) (fixed random R_i) by the whole-model rule. Returns
    the number of parameters compared. The JAX outputs and gradients come
    from one compiled function."""
    shapes = jax.eval_shape(jmodule.apply, variables, jin)
    rng = np.random.RandomState(seed)
    proj = [rng.randn(*w.shape).astype(np.float32) for w in shapes]

    def jloss(params):
        outs = jmodule.apply({**variables, 'params': params}, jin)
        return sum((o * p).sum() for o, p in zip(outs, proj)), outs
    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables['params'])
    got = tmodule(tin)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = _np(g.permute(0, 2, 3, 1))
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=OUT_REL, err_msg=f'out {i}',
                                   atol=OUT_REL * np.abs(w).max())

    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(p)).sum()
        for o, p in zip(got, proj)).backward()
    jg = {k: v.numpy() for k, v in
          state_dict_from_jax({'params': {comp: jgrads}}).items()}
    floor = GRAD_FLOOR * max(np.abs(v).max() for v in jg.values())
    tgrads = dict(Wrapped(tmodule, comp).named_parameters())
    beyond = total = checked = 0
    for name, want in jg.items():
        got = tgrads[name].grad
        if got is None or not want.any():
            assert got is None or not got.any(), name
            assert not want.any(), name
            continue
        diff = np.abs(_np(got) - want) / max(np.abs(want).max(), floor)
        assert diff.max() <= MODEL_GRAD_REL, (name, diff.max())
        beyond += int((diff > MODEL_F32_REL).sum())
        total += diff.size
        checked += 1
    assert beyond <= MODEL_FLIP_SHARE * total, beyond / total
    return checked


def _round_trip(tmodule, comp, wrapped, skipped_ok=()):
    """port state_dict -> torch_convert -> flax leaves: nothing skipped but
    what the JAX converter skips by name (``skipped_ok``), every converted
    leaf back as it was; load_reference_state skips the same keys, and
    refuses what the JAX route refuses: a mapped key the module lacks
    (KeyError) and a weight of another shape (ValueError)."""
    state = Wrapped(tmodule, comp).state_dict()
    params, stats, skipped = convert_state_dict(state)
    assert sorted(skipped) == sorted(k for k in state
                                     if k.startswith(skipped_ok))
    merged = merge_into_variables(wrapped, params, stats, strict=True)
    flat = jax.tree_util.tree_flatten_with_path
    for (pa, a), (pb, b) in zip(flat(merged)[0], flat(wrapped)[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fresh = dict(state)
    assert sorted(load_reference_state(Wrapped(tmodule, comp), fresh)) == \
        sorted(skipped)
    weight = next(k for k, v in state.items() if k.endswith('.weight')
                  and v.dim() == 4 and not k.startswith(skipped_ok))
    extra = 'backbone.layer1.0.conv9.weight' if comp == 'backbone' \
        else 'neck.lateral_convs.9.conv.weight'
    for bad, err in (({extra: torch.zeros(4, 4, 1, 1)}, KeyError),
                     ({weight: torch.zeros(1, *state[weight].shape)
                       [0, :-1]}, ValueError)):
        with pytest.raises(err):
            load_reference_state(Wrapped(tmodule, comp), bad)
        p, s, _ = convert_state_dict(bad)
        with pytest.raises(err):
            merge_into_variables(wrapped, p, s, strict=True)


# ---------------------------------------------------------------- backbones
BACKBONES = {
    # caffe style: strides on the first 1x1, frozen K4 + K5 prefix kept
    'r50_caffe': BackboneConfig(depth=50, style='caffe', frozen_stages=1),
    'r50_caffe_unfrozen': BackboneConfig(depth=50, style='caffe',
                                         frozen_stages=-1,
                                         out_indices=(1, 2, 3)),
    'r18': BackboneConfig(depth=18, frozen_stages=1),
    'r34': BackboneConfig(depth=34, frozen_stages=0, out_indices=(1, 2, 3)),
    'x50_8x4d': BackboneConfig(type='ResNeXt', depth=50, groups=8,
                               base_width=4, frozen_stages=1),
    'x50_8x4d_dcn': BackboneConfig(type='ResNeXt', depth=50, groups=8,
                                   base_width=4, frozen_stages=1,
                                   dcn_stages=(1, 2, 3)),
    'r50_plugins': BackboneConfig(depth=50, frozen_stages=1,
                                  gcb_stages=(1,), nonlocal_stages=(2,),
                                  gen_attention_stages=(3,)),
}
# the JAX converter maps no key of a backbone's non-local block
SKIPPED = {'r50_plugins': tuple(f'backbone.layer3.{i}.nonlocal_block.'
                                for i in range(6))}


@pytest.fixture(scope='module', params=sorted(BACKBONES))
def backbone(request):
    bcfg = BACKBONES[request.param]
    cfg = KGDetConfig(backbone=bcfg)
    jmodule = jbuild_backbone(cfg, jnp.float32)
    tmodule = build_backbone(bcfg)
    x = np.random.RandomState(2).randn(2, *CANVAS, 3).astype(np.float32)
    variables, wrapped = _pair(jmodule, tmodule, 'backbone',
                               jnp.asarray(x[:1]))
    return request.param, jmodule, tmodule, variables, wrapped, x


def test_backbone_structure(backbone):
    """The type, block and prefix gate the JAX module takes: caffe style
    on the frozen prefix, BasicBlock and ResNeXt without it; grouped 3x3
    and grouped DCN widths; the plugins where the JAX blocks put them."""
    name, _, tmodule, _, _, _ = backbone
    if name.startswith('r50_caffe'):
        blk = tmodule.layer3[0]
        assert blk.conv1.stride == (2, 2) and blk.conv2.stride == (1, 1)
        assert tmodule.use_prefix == (name == 'r50_caffe')
    if name in ('r18', 'r34'):
        assert isinstance(tmodule.layer1[0], BasicBlock)
        assert not tmodule.use_prefix
    if name.startswith('x50'):
        assert isinstance(tmodule, ResNeXt) and not tmodule.use_prefix
        conv2 = tmodule.layer2[0].conv2
        assert conv2.groups == 8
        if name.endswith('dcn'):
            assert isinstance(conv2, DeformConv3x3)
            assert conv2.weight.shape == (64, 8, 3, 3)
        else:
            assert conv2.weight.shape == (64, 8, 3, 3)
    if name == 'r50_plugins':
        assert tmodule.use_prefix
        assert isinstance(tmodule.layer2[0].context_block,
                          plugins.ContextBlock)
        assert isinstance(tmodule.layer3[0].nonlocal_block,
                          plugins.NonLocal2D)
        assert isinstance(tmodule.layer4[0].gen_attention_block,
                          plugins.GeneralizedAttention)


def test_backbone_outputs_and_gradients_match_jax(backbone):
    name, jmodule, tmodule, variables, _, x = backbone
    checked = _check_forward_and_grads(jmodule, tmodule, variables,
                                       'backbone', jnp.asarray(x),
                                       torch.from_numpy(x))
    assert checked > 10, name


def test_backbone_round_trip_and_pth_route(backbone):
    name, _, tmodule, _, wrapped, _ = backbone
    _round_trip(tmodule, 'backbone', wrapped, SKIPPED.get(name, ()))


def test_grouped_dcn_contracts_block_diagonally():
    """DeformConv3x3 with groups: at zero offsets it is the grouped 3x3
    conv (stride 1 and 2), within 1e-5 of scale; its plain switch is the
    module's."""
    torch.manual_seed(0)
    for stride in (1, 2):
        dcn = DeformConv3x3(16, 24, stride=stride, groups=4)
        nn.init.normal_(dcn.weight)
        x = torch.randn(2, 16, 9, 11)
        ho, wo = -(-9 // stride), -(-11 // stride)
        got = dcn(x, torch.zeros(2, 18, ho, wo))
        want = torch.nn.functional.conv2d(x, dcn.weight, stride=stride,
                                          padding=1, groups=4)
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


# ------------------------------------------------------------------ plugins
PLUGIN_CASES = {
    'gcb_att_add': (lambda: jplugins.ContextBlock(),
                    lambda: plugins.ContextBlock(64)),
    'gcb_avg_add_mul': (lambda: jplugins.ContextBlock(
        pooling_type='avg', fusion_types=('channel_add', 'channel_mul')),
        lambda: plugins.ContextBlock(64, pooling_type='avg', fusion_types=(
            'channel_add', 'channel_mul'))),
    'nonlocal': (lambda: jplugins.NonLocal2D(),
                 lambda: plugins.NonLocal2D(64)),
    'gen_attention_1111': (lambda: jplugins.GeneralizedAttention(
        num_heads=4), lambda: plugins.GeneralizedAttention(64, num_heads=4)),
    'gen_attention_0011_range': (
        lambda: jplugins.GeneralizedAttention(
            num_heads=4, attention_type='0011', spatial_range=2,
            kv_stride=1),
        lambda: plugins.GeneralizedAttention(
            64, num_heads=4, attention_type='0011', spatial_range=2,
            kv_stride=1)),
    'gen_attention_0100': (
        lambda: jplugins.GeneralizedAttention(
            num_heads=8, attention_type='0100', position_embedding_dim=32),
        lambda: plugins.GeneralizedAttention(
            64, num_heads=8, attention_type='0100',
            position_embedding_dim=32)),
}
PLUGIN_NAMES = {'gcb': 'context_block', 'nonlocal': 'nonlocal_block',
                'gen': 'gen_attention_block'}


class _InBlock(nn.Module):
    """A plugin at the name a backbone block gives it (layer1.0.<name>),
    so the converter's backbone names reach it."""

    def __init__(self, name, module):
        super().__init__()
        self.layer1 = nn.ModuleList([nn.Module()])
        self.layer1[0].add_module(name, module)


@pytest.mark.parametrize('case', sorted(PLUGIN_CASES))
def test_plugin_matches_jax(case):
    """Each plugin alone on a (2, 8, 12, 64) map: output within 1e-4 of
    scale and every parameter's gradient within 1e-4 of its scale (of
    GRAD_FLOOR times the largest, for a gradient that is zero in exact
    arithmetic)."""
    jmake, tmake = PLUGIN_CASES[case]
    jmodule, tmodule = jmake(), tmake()
    name = PLUGIN_NAMES[case.split('_')[0]]
    x = np.random.RandomState(3).randn(2, 8, 12, 64).astype(np.float32)
    variables = _perturb(dict(jax.jit(jmodule.init)(
        jax.random.PRNGKey(0), jnp.asarray(x))))
    wrapped = {'params': {'backbone': {'layer1/0': {
        name: variables['params']}}}}
    state = {k[len('backbone.'):]: v
             for k, v in state_dict_from_jax(wrapped).items()}
    holder = _InBlock(name, tmodule)
    holder.load_state_dict(state, strict=True)
    want = jax.jit(jmodule.apply)(variables, jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tmodule(xt)
    w = np.asarray(want)
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), w, rtol=1e-4,
                               atol=1e-4 * np.abs(w).max())
    proj = np.random.RandomState(4).randn(*w.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: (jmodule.apply(
        {'params': p}, jnp.asarray(x)) * proj).sum()))(variables['params'])
    (got.permute(0, 2, 3, 1) * torch.from_numpy(proj)).sum().backward()
    jstate = {k: v.numpy() for k, v in state_dict_from_jax(
        {'params': {'backbone': {'layer1/0': {name: jg}}}}).items()}
    floor = GRAD_FLOOR * max(np.abs(v).max() for v in jstate.values())
    tparams = dict(holder.named_parameters())
    for k, want_g in jstate.items():
        got_g = tparams[k[len('backbone.'):]].grad
        np.testing.assert_allclose(_np(got_g), want_g, rtol=1e-4, err_msg=k,
                                   atol=1e-4 * max(np.abs(want_g).max(),
                                                   floor))


# -------------------------------------------------------------------- necks
def _fpn_inputs(chans, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, CANVAS[0] // s, CANVAS[1] // s, c)
            .astype(np.float32) for s, c in zip((4, 8, 16, 32), chans)]


NECKS = {
    'hrfpn': NeckConfig(type='HRFPN', in_channels=(8, 16, 32, 64),
                        out_channels=32, num_outs=5),
    'fpnbfp_non_local': NeckConfig(
        type='FPNBFP', in_channels=(32, 64, 128, 256), out_channels=32,
        start_level=0, num_outs=5, add_extra_convs=False, select_out=None,
        norm=None, bfp_refine_level=2, bfp_refine_type='non_local'),
    'fpnbfp_conv_select': NeckConfig(
        type='FPNBFP', in_channels=(32, 64, 128, 256), out_channels=32,
        start_level=1, num_outs=4, add_extra_convs=True, select_out=(0, 2),
        norm='gn', gn_groups=8, bfp_refine_level=1, bfp_refine_type='conv'),
    'fpnbfp_no_refine': NeckConfig(
        type='FPNBFP', in_channels=(32, 64, 128, 256), out_channels=32,
        start_level=0, num_outs=5, add_extra_convs=False, select_out=None,
        norm=None, bfp_refine_level=3, bfp_refine_type='none'),
    'bfp_conv': NeckConfig(type='BFP', out_channels=32, num_outs=4,
                           bfp_refine_level=1, bfp_refine_type='conv'),
}


@pytest.mark.parametrize('name', sorted(NECKS))
def test_neck_outputs_gradients_and_round_trip(name):
    """HRFPN (bilinear up, avg pools), FPNBFP with each refine (non-local,
    conv, none) and a level selection, BFP alone: outputs within 1e-4 of
    scale,
    gradients by the whole-model rule, the round trip with nothing
    skipped and the .pth route."""
    ncfg = NECKS[name]
    cfg = KGDetConfig(neck=ncfg)
    jmodule = jbuild_neck(cfg, jnp.float32)
    tmodule = build_neck(ncfg)
    chans = (32,) * 4 if ncfg.type == 'BFP' else ncfg.in_channels
    feats = _fpn_inputs(chans)
    variables, wrapped = _pair(jmodule, tmodule, 'neck',
                               [jnp.asarray(f[:1]) for f in feats])
    checked = _check_forward_and_grads(
        jmodule, tmodule, variables, 'neck', [jnp.asarray(f) for f in feats],
        [_nchw(f) for f in feats])
    assert checked >= 2
    _round_trip(tmodule, 'neck', wrapped)


def test_hrfpn_max_pooling_matches_jax():
    """HRFPN(pooling='max'), which no config selects: the pyramid within
    1e-4 of scale."""
    jmodule = JHRFPN(in_channels=(8, 16), out_channels=16, num_outs=3,
                     pooling='max')
    tmodule = HRFPN((8, 16), 16, 3, pooling='max')
    feats = _fpn_inputs((8, 16))[:2]
    variables, _ = _pair(jmodule, tmodule, 'neck',
                         [jnp.asarray(f) for f in feats])
    want = jmodule.apply(variables, [jnp.asarray(f) for f in feats])
    got = tmodule([_nchw(f) for f in feats])
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g.permute(0, 2, 3, 1)), w,
                                   rtol=1e-4, atol=1e-4 * np.abs(w).max())
