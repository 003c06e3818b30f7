"""HRNet and the backbones and necks of the four two-stage config files in
the port (kgdet_tpu_torch: models/hrnet.py, HRFPN and FPNBFP of
models/necks_extra.py, the caffe-style C4 ResNet and ResNeXt-101 32x4d of
models/resnet.py) against kgdet_tpu, with the helpers and tolerances of
tests/test_torch_backbones.py: HRNet-W8's outputs within 1e-4 of scale and
every gradient by the whole-model rule, its round trip and ``.pth`` route;
each two-stage config file as it ships, built through build_backbone /
build_neck in both packages (``build_model`` raises for two-stage until
ROADMAP Queue 1 item 6), the neck's outputs within 1e-4 of scale.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgdet_tpu.config import BackboneConfig, KGDetConfig
from kgdet_tpu.config import load_config as jload_config
from kgdet_tpu.models.detector import build_backbone as jbuild_backbone
from kgdet_tpu.models.detector import build_neck as jbuild_neck
from kgdet_tpu.utils.torch_convert import (convert_state_dict,
                                           merge_into_variables)
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.models import plugins
from kgdet_tpu_torch.models.detector import build_backbone, build_neck
from kgdet_tpu_torch.models.hrnet import HRNet
from kgdet_tpu_torch.models.necks_extra import BFP, FPNBFP, HRFPN
from kgdet_tpu_torch.models.resnet import ResNet, ResNeXt
from tests.test_torch_backbones import CANVAS, Wrapped, _np, _pair, \
    _check_forward_and_grads, _round_trip

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# HRNet-W8's own case: a smaller canvas that its stride-32 branch takes
SMALL_CANVAS = (32, 64)


def test_hrnet_outputs_gradients_round_trip_and_pth_route():
    """HRNet-W8 (transitions, three stages of HR modules, the fusions):
    its four branches within 1e-4 of scale, every gradient by the
    whole-model rule, the round trip with nothing skipped and the .pth
    route."""
    bcfg = BackboneConfig(type='HRNet', hrnet_width=8, frozen_stages=-1)
    jmodule = jbuild_backbone(KGDetConfig(backbone=bcfg), jnp.float32)
    tmodule = build_backbone(bcfg)
    assert isinstance(tmodule, HRNet)
    x = np.random.RandomState(2).randn(2, *SMALL_CANVAS, 3) \
        .astype(np.float32)
    variables, wrapped = _pair(jmodule, tmodule, 'backbone',
                               jnp.asarray(x[:1]))
    assert _check_forward_and_grads(jmodule, tmodule, variables, 'backbone',
                                    jnp.asarray(x), torch.from_numpy(x)) \
        > 100
    _round_trip(tmodule, 'backbone', wrapped)


TWO_STAGE = ('faster_rcnn_r50_caffe_c4_1x_deepfashion2.py',
             'faster_rcnn_x101_32x4d_fpn_1x_deepfashion2.py',
             'faster_rcnn_hrnetv2p_w32_1x_deepfashion2.py',
             'libra_faster_rcnn_r50_fpn_1x_deepfashion2.py')


@pytest.mark.parametrize('path', TWO_STAGE)
def test_two_stage_config_backbone_and_neck_match_jax(path):
    """The backbone and neck of each two-stage config file, built as the
    file says through build_backbone / build_neck in both packages (the
    c4 recipe has no neck): the neck's (or the backbone's) outputs within
    1e-4 of scale on one 64x96 image, the backbone's parameters under the
    JAX converter's names."""
    full = os.path.join(ROOT, 'configs', path)
    jcfg, cfg = jload_config(full), load_config(full)
    assert cfg.backbone == type(cfg.backbone)(
        **dataclasses.asdict(jcfg.backbone))
    jb, tb = jbuild_backbone(jcfg, jnp.float32), build_backbone(cfg.backbone)
    x = np.random.RandomState(7).randn(1, *CANVAS, 3).astype(np.float32)
    bvars, bwrapped = _pair(jb, tb, 'backbone', jnp.asarray(x))
    jn, tn = jbuild_neck(jcfg, jnp.float32), build_neck(cfg.neck)
    with torch.no_grad():
        feats = tb(torch.from_numpy(x))
    if jn is None:
        assert tn is None and cfg.neck.type == 'Identity'
        got, want = feats, jax.jit(jb.apply)(bvars, jnp.asarray(x))
    else:
        # the neck's variables from the features' shapes; then backbone
        # and neck as one compiled function
        shapes = jax.eval_shape(jb.apply, bvars, jnp.asarray(x))
        nvars, _ = _pair(jn, tn, 'neck', [jnp.zeros(f.shape, f.dtype)
                                          for f in shapes])
        with torch.no_grad():
            got = tn(feats)
        want = jax.jit(lambda b, n, x: jn.apply(n, jb.apply(b, x)))(
            bvars, nvars, jnp.asarray(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(_np(g.permute(0, 2, 3, 1)), w,
                                   rtol=1e-4, atol=1e-4 * np.abs(w).max())
    params, stats, skipped = convert_state_dict(
        Wrapped(tb, 'backbone').state_dict())
    assert skipped == []
    merge_into_variables(bwrapped, params, stats, strict=True)
    if 'x101' in path:
        assert isinstance(tb, ResNeXt) and tb.layer1[0].conv2.groups == 32
    if 'hrnet' in path:
        assert isinstance(tn, HRFPN) and isinstance(tb, HRNet)
    if 'libra' in path:
        assert isinstance(tn, FPNBFP)
        assert isinstance(getattr(tn, '1'), BFP)
        assert isinstance(getattr(tn, '1').refine, plugins.NonLocal2D)
    if 'c4' in path:
        assert isinstance(tb, ResNet) and tb.num_stages == 3
        assert tb.layer2[0].conv1.stride == (2, 2)
