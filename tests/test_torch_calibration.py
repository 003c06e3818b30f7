"""ConvModule(norm='frozen_bn') and FrozenBatchNorm calibration in the port
(kgdet_tpu_torch: models/layers.py, utils/bn_calibration.py) against
kgdet_tpu on the same weights and batches.

frozen_bn: the demo config with ``neck.norm='frozen_bn'`` at full width,
and the tiny R-18 config with both the neck and the head on it; head
outputs within the tolerances of tests/test_torch_model.py (1e-4, 5e-4 on
the moment boxes) of scale (the largest output, at least 1: at full width
the 30x output kernels of ``_perturb`` put the keypoint offsets past 1),
the state_dict round trip with nothing missing or
extra, and the .pth route, which drops exactly the keys the JAX
converter skips: the BNs under a neck or head ConvModule, which
kgdet_tpu/utils/torch_convert.py maps onto nothing.

Calibration: tests/common.py::tiny_cfg (ResNet-18, as
tests/test_variants.py::test_frozen_bn_calibration runs it) and
tests/test_torch_model.py::tiny_r50_cfg (the folded K4 / K5 prefix).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.config import load_config as jload_config
from kgdet_tpu.utils.bn_calibration import calibrate_frozen_bn as jcalibrate
from kgdet_tpu.utils.torch_convert import convert_state_dict
from kgdet_tpu_torch.api import build_model
from kgdet_tpu_torch.models.layers import FrozenBatchNorm
from kgdet_tpu_torch.utils.bn_calibration import calibrate_frozen_bn
from kgdet_tpu_torch.utils.convert import load_reference_state, \
    state_dict_from_jax
from tests.common import tiny_cfg
from tests.test_torch_model import CANVAS, ROOT, _perturb, tiny_r50_cfg

torch.set_num_threads(1)


def _pair(cfg, perturb=True):
    jmodel = jbuild_model(cfg)
    variables = init_variables(jmodel, cfg, canvas_hw=CANVAS)
    if perturb:
        variables = _perturb(variables)
    port = build_model(cfg, device='cpu')
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmodel, variables, port.eval()


def _frozen_bn_cfg(which):
    if which == 'demo_neck':
        cfg = jload_config(os.path.join(
            ROOT, 'configs', 'kgdet_moment_r50_fpn_1x_demo.py'))
        return cfg.replace(neck=dataclasses.replace(cfg.neck,
                                                    norm='frozen_bn'))
    cfg = tiny_cfg()
    return cfg.replace(
        neck=dataclasses.replace(cfg.neck, norm='frozen_bn'),
        head=dataclasses.replace(cfg.head, norm='frozen_bn'))


@pytest.mark.parametrize('which', ['demo_neck', 'tiny_neck_and_head'])
def test_frozen_bn_conv_module_matches_jax(which):
    cfg = _frozen_bn_cfg(which)
    jmodel, variables, port = _pair(cfg)
    bns = [n for n, m in port.named_modules()
           if isinstance(m, FrozenBatchNorm) and n.endswith('.bn')]
    assert bns and all(n.startswith(('neck.', 'bbox_head.')) for n in bns)
    assert any(n.startswith('bbox_head.') for n in bns) == \
        (which != 'demo_neck')
    img = np.random.RandomState(1).randn(2, *CANVAS, 3).astype(np.float32)
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(img))
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    assert len(got) == len(want)
    for g_lvl, w_lvl in zip(got, want):
        for k, tol in (('cls', 1e-4), ('kpt', 1e-4), ('bbox', 5e-4)):
            g, w = g_lvl[k].numpy(), np.asarray(w_lvl[k])
            assert g.shape == w.shape, k
            np.testing.assert_allclose(
                g, w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()),
                err_msg=k)
    # the round trip: every key of the port's model from the flax tree
    state = state_dict_from_jax(variables)
    assert sorted(state) == sorted(port.state_dict())
    # the .pth route drops what the JAX converter skips, and only that
    _, _, jskipped = convert_state_dict(state)
    fresh = build_model(cfg, device='cpu')
    skipped = load_reference_state(fresh, state)
    assert sorted(skipped) == sorted(jskipped)
    assert {k.rsplit('.', 1)[0] for k in skipped} == set(bns)


def _batches():
    rng = np.random.RandomState(0)
    return [rng.randn(2, *CANVAS, 3).astype(np.float32) * 3
            for _ in range(2)]


def _stats(state):
    return {k: v.numpy() for k, v in state.items()
            if k.endswith(('running_mean', 'running_var'))}


def _assert_stats_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(np.abs(want[k]).max(), 1e-6)
        err = np.abs(got[k] - want[k]).max() / scale
        assert err <= tol, (k, err)


@pytest.fixture(scope='module')
def r18():
    cfg = tiny_cfg()
    jmodel, variables, _ = _pair(cfg, perturb=False)
    return cfg, jmodel, variables


@pytest.mark.parametrize('passes', [1, 3])
def test_calibration_matches_jax_r18(r18, passes):
    """Every stat within 1e-4 of its scale (its largest value). Three
    passes feed each pass's stats back into the next, so the two packages'
    f32 rounding compounds; read on this config: at worst 1.8e-6 of scale
    after one pass and 4.9e-6 after three, so the one-pass bound holds
    for three with room."""
    cfg, jmodel, variables = r18
    port = build_model(cfg, device='cpu')
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    batches = _batches()
    jvars, jn = jcalibrate(jmodel, variables, batches, passes=passes)
    n = calibrate_frozen_bn(port, batches, passes=passes)
    assert n == jn > 10
    assert n == sum(isinstance(m, FrozenBatchNorm) for m in port.modules())
    _assert_stats_close(_stats(port.state_dict()),
                        _stats(state_dict_from_jax(jvars)), 1e-4)
    assert np.abs(port.backbone.bn1.running_mean.numpy()).max() > 1e-3


def test_calibration_matches_jax_r50_and_refolds_the_prefix():
    """The R-50 whose stem and layer1 run as the folded prefix: the hooks
    see those BNs through the unfolded chain; afterwards the prefix route
    (plain kernels on the CPU) reads the refolded weights and equals the
    unfolded chain."""
    cfg = tiny_r50_cfg()
    jmodel, variables, port = _pair(cfg, perturb=False)
    backbone = port.backbone
    assert backbone.use_prefix
    x = torch.from_numpy(_batches()[0])
    with torch.no_grad():
        before = backbone(x)[-1]            # keeps the folded weights
    batches = _batches()
    jvars, jn = jcalibrate(jmodel, variables, batches, passes=1)
    n = calibrate_frozen_bn(port, batches, passes=1)
    assert n == jn == sum(isinstance(m, FrozenBatchNorm)
                          for m in port.modules())
    _assert_stats_close(_stats(port.state_dict()),
                        _stats(state_dict_from_jax(jvars)), 1e-4)
    assert backbone.use_prefix
    with torch.no_grad():
        prefix = backbone(x)
        backbone.use_prefix = False
        chain = backbone(x)
        backbone.use_prefix = True
    for p, c in zip(prefix, chain):
        np.testing.assert_allclose(p.numpy(), c.numpy(), rtol=1e-4,
                                   atol=1e-4 * np.abs(c.numpy()).max())
    assert not np.allclose(before.numpy(), prefix[-1].numpy())
