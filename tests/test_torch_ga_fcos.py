"""GA-Retina and FCOS in the port (kgdet_tpu_torch: ops/losses.py,
models/fcos_head.py, core/fcos_loss.py, models/ga_head.py,
core/ga_loss.py, their records in models/families.py) against kgdet_tpu.

Seeded NumPy inputs go through both packages on the CPU in f32, models with
the same weights (flax variables carried into the port through
``utils/convert.py::state_dict_from_jax``): every loss of ops/losses.py and
its gradient (1e-5 relative, gradients 1e-5 of scale), FCOS's and GA's
targets (labels, masks and weights equal; distances and centerness 1e-5),
the GA approx assignment against a NumPy loop, both families' loss terms
and their gradients with respect to the head outputs (1e-4 of scale), both
decodes (labels and ``valid`` equal, boxes 1e-4), tiny caffe-style R-50
models of both families (head outputs 1e-4 of scale, loss terms 1e-4,
every parameter's gradient by the whole-model rule of ROADMAP "Standing
findings", detections), the state-dict round trips and ``.pth`` routes, and
the data-parallel convention of the losses (two shards with the global
counts add up to the whole batch within 1e-5). Tolerances are stated at
each assert.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.api import make_predict_fn as jmake_predict_fn
from kgdet_tpu.config import AssignConfig, BackboneConfig, DataConfig, \
    HeadConfig, KGDetConfig, NeckConfig, OptimConfig
from kgdet_tpu.config import TestConfig as TestCfg
from kgdet_tpu.core import fcos_loss as jfcos
from kgdet_tpu.core import ga_loss as jga
from kgdet_tpu.ops import losses as jlosses
from kgdet_tpu.parallel import train as jtrain
from kgdet_tpu.utils.torch_convert import (convert_state_dict,
                                           merge_into_variables)
from kgdet_tpu_torch.api import build_model, init_trainer, make_predict_fn
from kgdet_tpu_torch.core import fcos_loss, ga_loss
from kgdet_tpu_torch.models.families import get_head_family, level_grids
from kgdet_tpu_torch.models.ga_head import FeatureAdaption, GARPNHead
from kgdet_tpu_torch.models.resnet import DeformConv3x3
from kgdet_tpu_torch.ops import losses
from kgdet_tpu_torch.parallel import train as ttrain
from kgdet_tpu_torch.utils.convert import (load_reference_state,
                                           state_dict_from_jax)
from tests.common import synth_batch

torch.set_num_threads(1)
CANVAS = (64, 96)
STRIDES = (8, 16, 32)
MODEL_F32_REL, MODEL_GRAD_REL, MODEL_FLIP_SHARE = 1e-3, 5e-2, 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close_scaled(got, want, rel, err_msg=''):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=rel, err_msg=err_msg,
                               atol=rel * max(np.abs(want).max(), 1e-12))


# ------------------------------------------------------------------ losses
def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(1, 40, (n, 2))],
                          -1).astype(np.float32)


def _loss_case(name, rng):
    """(positional inputs, keyword options) of one loss, seeded; the input
    that is differentiated comes first."""
    n = 40
    w = (rng.rand(n) > 0.3).astype(np.float32)
    if name in ('iou_loss', 'giou_loss'):
        pred, tgt = _boxes(rng, n), _boxes(rng, n)
        tgt[:10] = pred[:10] + rng.uniform(-3, 3, (10, 4))
        return (pred, tgt), dict(weights=w, avg_factor=7.0)
    if name == 'bounded_iou_loss':
        pred, tgt = _boxes(rng, n), _boxes(rng, n)
        tgt[:20] = pred[:20] + rng.uniform(-4, 4, (20, 4))
        return (pred, tgt), dict(weights=np.repeat(w[:, None], 4, 1),
                                 avg_factor=11.0)
    if name in ('balanced_l1_loss', 'mse_loss'):
        pred = rng.randn(n, 4).astype(np.float32) * 1.5
        return (pred, rng.randn(n, 4).astype(np.float32)), dict(
            weights=np.repeat(w[:, None], 4, 1), avg_factor=9.0)
    if name == 'cross_entropy_loss':
        return (rng.randn(n, 14).astype(np.float32) * 2,
                rng.randint(0, 14, n).astype(np.int32)), dict(
                    weights=w, avg_factor=13.0)
    labels = rng.randint(0, 14, n).astype(np.int32)         # ghm_c_loss
    return (rng.randn(n, 13).astype(np.float32) * 3, labels), dict(
        weights=w)


@pytest.mark.parametrize('name', [
    'iou_loss', 'giou_loss', 'bounded_iou_loss', 'cross_entropy_loss',
    'balanced_l1_loss', 'ghm_c_loss', 'mse_loss'])
@pytest.mark.parametrize('weighted', [True, False])
def test_losses_and_gradients_match_jax(name, weighted):
    """Each loss of ops/losses.py that FCOS, GA-Retina or no module yet
    calls, with and without weights and an average factor: the value 1e-5
    relative and its gradient with respect to the first input 1e-5 of
    scale."""
    args, kw = _loss_case(name, np.random.RandomState(len(name)))
    if not weighted:
        kw = {}
    jfn, tfn = getattr(jlosses, name), getattr(losses, name)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jval, jgrad = jax.value_and_grad(
        lambda x: jfn(x, *map(jnp.asarray, args[1:]), **jkw))(
            jnp.asarray(args[0]))
    x = _t(args[0]).requires_grad_()
    val = tfn(x, *map(_t, args[1:]), **{k: _t(v) if isinstance(
        v, np.ndarray) else v for k, v in kw.items()})
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    _close_scaled(x.grad, jgrad, 1e-5, name)


# ------------------------------------------------------------------ targets
def _gts(rng, B=2, G=5, lo=4, hi=60):
    xy = rng.uniform(0, 70, (B, G, 2))
    gts = np.concatenate([xy, xy + rng.uniform(lo, hi, (B, G, 2))],
                         -1).astype(np.float32)
    mask = np.ones((B, G), bool)
    mask[1, -2:] = False
    labels = rng.randint(1, 14, (B, G)).astype(np.int32)
    return gts, labels, mask


def _grids(canvas=CANVAS, strides=STRIDES):
    cfg = KGDetConfig(head=HeadConfig(point_strides=strides))
    return [np.asarray(g) for g in jtrain.build_level_geometry(cfg, canvas)]


def test_fcos_regress_ranges_and_targets_match_jax():
    """regress_ranges_for equal; fcos_targets on three levels (labels and
    positives equal, distances and centerness 1e-5), with a duplicated GT
    so that the least-area rule meets a tie (the first GT wins)."""
    for n in (1, 3, 5):
        assert fcos_loss.regress_ranges_for(n) == jfcos.regress_ranges_for(n)
    rng = np.random.RandomState(0)
    gts, labels, mask = _gts(rng, lo=4, hi=150)
    gts[0, 1] = gts[0, 0]
    labels[0, 1] = (labels[0, 0] % 13) + 1
    grids = _grids()
    points = np.concatenate(grids)
    rr = jfcos.regress_ranges_for(3)
    ranges = np.concatenate([np.tile(np.float32(rr[i]), (len(g), 1))
                             for i, g in enumerate(grids)]).astype(np.float32)
    valid = rng.rand(2, len(points)) > 0.1
    want = jax.vmap(lambda v, gb, gl, gm: jfcos.fcos_targets(
        jnp.asarray(points), jnp.asarray(ranges), v, gb, gl, gm))(
            *map(jnp.asarray, (valid, gts, labels, mask)))
    got = fcos_loss.fcos_targets(_t(points), _t(ranges), *map(
        _t, (valid, gts, labels, mask)))
    assert np.asarray(want[1]).sum() >= 8
    for i in (0, 1):
        np.testing.assert_array_equal(_np(got[i]), np.asarray(want[i]))
    for i in (2, 3):
        np.testing.assert_allclose(_np(got[i]), np.asarray(want[i]),
                                   rtol=1e-5, atol=1e-5)
    assert (_np(got[0])[0] == labels[0, 1]).sum() == 0


def test_ga_loc_targets_match_jax():
    """ga_loc_targets on three levels: targets and weights equal, the
    average factor equal; boxes of every level, one on a rounding edge."""
    rng = np.random.RandomState(1)
    gts, _, mask = _gts(rng, lo=10, hi=120)
    gts[0, 0] = [4., 4., 36., 36.]
    sizes = [(-(-CANVAS[0] // s), -(-CANVAS[1] // s)) for s in STRIDES]
    want = jga.ga_loc_targets(jnp.asarray(gts), jnp.asarray(mask), STRIDES,
                              sizes, octave_base=4)
    got = ga_loss.ga_loc_targets(_t(gts), _t(mask), STRIDES, sizes,
                                 octave_base=4)
    assert got[2] == want[2]
    for lvl in range(3):
        np.testing.assert_array_equal(_np(got[0][lvl]),
                                      np.asarray(want[0][lvl]))
        np.testing.assert_array_equal(_np(got[1][lvl]),
                                      np.asarray(want[1][lvl]))
    assert sum(float(t.sum()) for t in got[0]) > 3


def test_ga_approx_assignment_matches_a_loop():
    """ga_approx_assign against the JAX package's rule written as a NumPy
    loop: a square's IoU is the best over its octave's approx anchors; the
    first best GT, then the last GT that claims the square at its own best
    IoU; equal GTs make ties."""
    rng = np.random.RandomState(2)
    gts, _, mask = _gts(rng, lo=10, hi=50)
    gts[0, 2] = gts[0, 1]
    approxs = np.concatenate([np.asarray(jga.ga_approx_anchors(
        s, 4, 2, (0.5, 1.0, 2.0), -(-CANVAS[0] // s), -(-CANVAS[1] // s)))
        for s in STRIDES])
    valid = rng.rand(2, len(approxs)) > 0.05
    assigned, pos = ga_loss.ga_approx_assign(
        _t(approxs), _t(valid), _t(gts), _t(mask), 0.5, 0.0)
    from kgdet_tpu.core.iou_assign import iou_xyxy as jiou
    for b in range(2):
        iou = np.asarray(jiou(jnp.asarray(gts[b]),
                              jnp.asarray(approxs.reshape(-1, 4))))
        iou = iou.reshape(len(gts[b]), -1, approxs.shape[1]).max(-1)
        ok = mask[b][:, None] & valid[b][None]
        iou = np.where(ok, iou, -1.0)
        want_a = iou.argmax(0)
        best = iou.max(1)
        want_p = iou.max(0) >= 0.5
        for g in range(len(gts[b])):
            claim = (iou[g] == best[g]) & (best[g] >= 0.0) & ok[g]
            want_a = np.where(claim, g, want_a)
            want_p = want_p | claim
        np.testing.assert_array_equal(_np(assigned[b]), want_a)
        np.testing.assert_array_equal(_np(pos[b]), want_p & valid[b])
    assert int(pos.sum()) >= 8


# ------------------------------------------------------- losses of a family
def _head_cfg(head_type):
    return HeadConfig(type=head_type, num_classes=13, point_strides=STRIDES,
                      octave_base_scale=4, scales_per_octave=2)


ASSIGN = AssignConfig(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)


def _family_outputs(head_type, rng, B=2):
    outs = []
    for s in STRIDES:
        h, w = -(-CANVAS[0] // s), -(-CANVAS[1] // s)
        o = {'cls': rng.randn(1, B, h, w, 13).astype(np.float32) * 2,
             'bbox': rng.randn(1, B, h, w, 4).astype(np.float32) * 0.3}
        if head_type == 'FCOSHead':
            o['bbox'] = np.exp(o['bbox'] * 2) * s * 2
            o['centerness'] = rng.randn(1, B, h, w, 1).astype(np.float32)
        else:
            o['shape'] = rng.randn(1, B, h, w, 2).astype(np.float32) * 0.5
            o['loc'] = rng.randn(1, B, h, w, 1).astype(np.float32) * 2
        outs.append(o)
    return outs


def _family_batch(seed, B=2):
    batch = synth_batch(canvas=CANVAS, B=B, G=4, K=3, seed=seed)
    batch['valid_hw'] = np.asarray([[64, 96], [48, 72]] * (B // 2),
                                   np.int32)
    return batch


def _valids(batch):
    cfg = KGDetConfig(head=HeadConfig(point_strides=STRIDES))
    return [np.asarray(v) for v in jtrain.batch_valid_flags(
        cfg, CANVAS, jnp.asarray(batch['valid_hw']))]


def _jax_family_loss(head_type, outs, batch, valids, grids):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if head_type == 'FCOSHead':
        return jfcos.fcos_loss(outs, [jnp.asarray(g) for g in grids],
                               [jnp.asarray(v) for v in valids], jb,
                               _head_cfg(head_type))
    return jga.ga_loss(outs, jb, _head_cfg(head_type), ASSIGN, CANVAS)


def _port_family_loss(head_type, outs, batch):
    tb = {k: _t(v) for k, v in batch.items()}
    if head_type == 'FCOSHead':
        return fcos_loss.fcos_loss(outs, [_t(g) for g in _grids()],
                                   [_t(v) for v in _valids(batch)], tb,
                                   _head_cfg(head_type))
    return ga_loss.ga_loss(outs, tb, _head_cfg(head_type), ASSIGN, CANVAS)


FAMILY_LOGS = {'FCOSHead': ('loss_cls', 'loss_bbox', 'loss_centerness',
                            'num_pos'),
               'GARetinaHead': ('loss_cls', 'loss_bbox', 'loss_loc',
                                'loss_shape', 'num_pos')}


@pytest.mark.parametrize('head_type', ['FCOSHead', 'GARetinaHead'])
def test_family_losses_and_their_gradients_match_jax(head_type):
    """fcos_loss / ga_loss on the same level outputs: every term 1e-5
    relative, the gradient of the total with respect to every output map
    1e-4 of its scale (GA's shape gradient flows through the bounded-IoU
    loss of the approx-assigned squares)."""
    outs = _family_outputs(head_type, np.random.RandomState(3))
    batch = _family_batch(seed=3)
    # the static grids and flags made outside the compiled loss
    valids, grids = _valids(batch), _grids()
    (jtotal, jlogs), jgrad = jax.jit(jax.value_and_grad(
        lambda o: _jax_family_loss(head_type, o, batch, valids, grids),
        has_aux=True))(jax.tree.map(jnp.asarray, outs))
    touts = [{k: _t(v).requires_grad_() for k, v in o.items()}
             for o in outs]
    total, logs = _port_family_loss(head_type, touts, batch)
    total.backward()
    assert sorted(logs) == sorted(FAMILY_LOGS[head_type])
    assert float(jlogs['num_pos']) >= 3
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for k in FAMILY_LOGS[head_type]:
        np.testing.assert_allclose(logs[k].item(), float(jlogs[k]),
                                   rtol=1e-5, err_msg=k)
    for lvl, (o, g) in enumerate(zip(touts, jgrad)):
        for k in o:
            _close_scaled(o[k].grad, g[k], 1e-4, f'{k} level {lvl}')


@pytest.mark.parametrize('head_type', ['FCOSHead', 'GARetinaHead'])
def test_family_decodes_match_jax(head_type):
    """decode_detections_fcos / _ga on the same outputs: labels, ``valid``
    and the width-3 dummy keypoints equal, boxes and scores 1e-4; nms_pre
    cuts the first level."""
    outs = _family_outputs(head_type, np.random.RandomState(4))
    test = TestCfg(nms_pre=60, max_per_class=10, max_per_img=20,
                   score_thr=0.02)
    img_hw = np.asarray([[64, 96], [48, 70]], np.float32)
    sf = np.asarray([1.0, 0.8], np.float32)
    jo = jax.tree.map(jnp.asarray, outs)
    to = [{k: _t(v) for k, v in o.items()} for o in outs]
    if head_type == 'FCOSHead':
        grids = _grids()
        want = jax.jit(lambda o, h, s: jfcos.decode_detections_fcos(
            o, grids, h, s, test, 13))(jo, jnp.asarray(img_hw),
                                       jnp.asarray(sf))
        got = fcos_loss.decode_detections_fcos(
            to, [_t(g) for g in _grids()], _t(img_hw), _t(sf), test, 13)
    else:
        hcfg = _head_cfg(head_type)
        want = jax.jit(lambda o, h, s: jga.decode_detections_ga(
            o, hcfg, CANVAS, h, s, test))(jo, jnp.asarray(img_hw),
                                          jnp.asarray(sf))
        got = ga_loss.decode_detections_ga(to, hcfg, CANVAS, _t(img_hw),
                                           _t(sf), test)
    assert np.asarray(want['valid']).sum() > 10
    for k in ('det_labels', 'valid', 'det_kpts'):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(_np(got['det_bboxes']),
                               np.asarray(want['det_bboxes']), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('head_type', ['FCOSHead', 'GARetinaHead'])
def test_two_shards_with_global_counts_add_up_to_the_batch(head_type,
                                                            monkeypatch):
    """The data-parallel convention without a process group: a batch of 4
    in two shards of 2; a first pass records every count each shard hands
    ``global_sum``, a second pass has ``global_sum`` return the sum of
    that count over both shards. The shards' losses (each term) and their
    gradients with respect to the outputs then add up to the whole batch's
    within 1e-5, as two processes' summed gradients do."""
    module = fcos_loss if head_type == 'FCOSHead' else ga_loss
    outs = _family_outputs(head_type, np.random.RandomState(5), B=4)
    batch = _family_batch(seed=5, B=4)

    def shard(i):
        sl = slice(2 * i, 2 * i + 2)
        return ([{k: v[:, sl] for k, v in o.items()} for o in outs],
                {k: v[sl] for k, v in batch.items()})

    seen = [[], []]
    for i in (0, 1):
        def record(t, i=i):
            seen[i].append(t.detach().clone())
            return t
        monkeypatch.setattr(module, 'global_sum', record)
        _port_family_loss(head_type, [{k: _t(v) for k, v in o.items()}
                                      for o in shard(i)[0]], shard(i)[1])
    assert len(seen[0]) == len(seen[1]) >= 2
    totals = [a + b for a, b in zip(*seen)]
    grads, parts = [], []
    for i in (0, 1):
        calls = iter(totals)
        monkeypatch.setattr(module, 'global_sum', lambda t: next(calls))
        o, b = shard(i)
        to = [{k: _t(v).requires_grad_() for k, v in x.items()} for x in o]
        total, logs = _port_family_loss(head_type, to, b)
        total.backward()
        parts.append((total, logs))
        grads.append(to)
    monkeypatch.undo()
    to = [{k: _t(v).requires_grad_() for k, v in o.items()} for o in outs]
    whole, wlogs = _port_family_loss(head_type, to, batch)
    whole.backward()
    np.testing.assert_allclose(parts[0][0].item() + parts[1][0].item(),
                               whole.item(), rtol=1e-5)
    for k in wlogs:
        got = parts[0][1][k].item() + (parts[1][1][k].item()
                                       if k != 'num_pos' else 0)
        np.testing.assert_allclose(got, wlogs[k].item(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for lvl, o in enumerate(to):
        for k in o:
            both = torch.cat([grads[0][lvl][k].grad, grads[1][lvl][k].grad],
                             dim=1)
            _close_scaled(both, _np(o[k].grad), 1e-5, f'{k} level {lvl}')


# ----------------------------------------------------------- whole models
def family_cfg(head_type):
    """Caffe-style R-50 (frozen_stages=1), a 3-level FPN at 64 channels
    (strides 8/16/32), the family's head with one GN tower conv a
    branch."""
    return KGDetConfig(
        backbone=BackboneConfig(depth=50, frozen_stages=1, style='caffe'),
        neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=64,
                        start_level=1, num_outs=3, add_extra_convs=True,
                        select_out=None, norm=None),
        head=HeadConfig(type=head_type, num_classes=13, in_channels=64,
                        feat_channels=64, stacked_convs=1, gn_groups=8,
                        norm='gn', octave_base_scale=4, scales_per_octave=2,
                        point_strides=STRIDES),
        assigner=ASSIGN,
        test=TestCfg(nms_pre=50, max_per_class=10, max_per_img=20,
                     score_thr=0.0),
        optim=OptimConfig(warmup_iters=2),
        val_data=DataConfig(img_scale=(96, 64), canvas_hw=(CANVAS,)),
    )


def _perturb(variables):
    """Random BN statistics (so folding is not the identity), FCOS scales
    off 1."""
    rng = np.random.RandomState(0)

    def f(path, v):
        key = getattr(path[-1], 'key', str(path[-1]))
        v = np.asarray(v)
        if key == 'mean':
            return (rng.randn(*v.shape) * 0.1).astype(np.float32)
        if key == 'var':
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        if key == 'scales':
            return rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        return v
    return jax.tree_util.tree_map_with_path(f, variables)


@pytest.fixture(scope='module', params=['FCOSHead', 'GARetinaHead'])
def family(request):
    cfg = family_cfg(request.param)
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
    (jtotal, jlogs), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)

    model = build_model(cfg, device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    total, logs = ttrain.make_loss_fn(model, cfg, CANVAS)(batch)
    total.backward()
    tgrads = {k: None if v.grad is None else v.grad.clone()
              for k, v in model.named_parameters()}
    model.zero_grad()
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, model=model,
                jlogs={k: float(v) for k, v in jlogs.items()},
                jtotal=float(jtotal),
                logs={k: v.item() for k, v in logs.items()},
                total=total.item(), tgrads=tgrads,
                jgrads={k: v.numpy() for k, v in state_dict_from_jax(
                    {'params': jgrads}).items()})


def test_family_builds_the_reference_names(family):
    """The reference's parameter names (one FCOS scale a level; GA's
    feature adaption on a DeformConv3x3 with an 18-channel offset conv),
    and the caffe-style backbone still on the frozen prefix."""
    model, head = family['model'], family['cfg'].head.type
    names = dict(model.named_parameters())
    assert model.backbone.use_prefix
    assert model.backbone.layer2[0].conv1.stride == (2, 2)
    assert model.backbone.layer2[0].conv2.stride == (1, 1)
    if head == 'FCOSHead':
        for i in range(3):
            assert names[f'bbox_head.scales.{i}.scale'].shape == ()
        for k in ('fcos_cls', 'fcos_reg', 'fcos_centerness'):
            assert f'bbox_head.{k}.weight' in names
    else:
        fa = model.bbox_head.feature_adaption_cls
        assert isinstance(fa, FeatureAdaption)
        assert isinstance(fa.conv_adaption, DeformConv3x3)
        assert names['bbox_head.feature_adaption_cls.conv_offset.weight'] \
            .shape == (18, 2, 1, 1)
        assert names['bbox_head.feature_adaption_reg.conv_adaption.weight'] \
            .shape == (64, 64, 3, 3)
        for k in ('conv_loc', 'conv_shape', 'retina_cls', 'retina_reg'):
            assert f'bbox_head.{k}.weight' in names


def test_family_head_outputs_match_jax(family):
    """Every level's output maps, f32, 1e-4 of each map's scale."""
    img = np.random.RandomState(3).randn(2, *CANVAS, 3).astype(np.float32)
    want = jax.jit(family['jmodel'].apply)(family['variables'],
                                           jnp.asarray(img))
    with torch.no_grad():
        got = family['model'](torch.from_numpy(img))
    assert len(got) == len(want) == 3
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            w_k = np.asarray(w[k])
            assert tuple(g[k].shape) == w_k.shape, k
            _close_scaled(g[k], w_k, 1e-4, f'{k} level {lvl}')


def test_family_loss_and_every_gradient_match_jax(family):
    """The loss terms (1e-4 relative) and every parameter's gradient by
    the whole-model rule (MODEL_GRAD_REL of its scale in every element,
    MODEL_F32_REL in all but MODEL_FLIP_SHARE of them); the head's and the
    neck's within MODEL_F32_REL in every element. The frozen prefix has
    none in the port and a zero one in JAX; GA's offset convs none in
    either (they read the detached shape)."""
    head = family['cfg'].head.type
    assert sorted(family['logs']) == sorted(FAMILY_LOGS[head])
    np.testing.assert_allclose(family['total'], family['jtotal'], rtol=1e-4)
    for k, v in family['jlogs'].items():
        np.testing.assert_allclose(family['logs'][k], v, rtol=1e-4,
                                   err_msg=k)
    beyond = total = checked = 0
    for name, want in family['jgrads'].items():
        got = family['tgrads'][name]
        if got is None or not want.any():
            assert got is None or not got.any(), name
            assert not want.any(), name
            continue
        diff = np.abs(_np(got) - want) / np.abs(want).max()
        assert diff.max() <= MODEL_GRAD_REL, (name, diff.max())
        if name.startswith(('neck.', 'bbox_head.')):
            assert diff.max() <= MODEL_F32_REL, (name, diff.max())
        beyond += int((diff > MODEL_F32_REL).sum())
        total += diff.size
        checked += 1
    assert beyond <= MODEL_FLIP_SHARE * total, beyond / total
    assert checked > 100


def test_family_predict_matches_jax(family):
    """make_predict_fn: labels and valid equal, boxes and scores within
    1e-3 (the outputs' 1e-4 through the decode), width-3 zero keypoints."""
    cfg = family['cfg']
    rng = np.random.RandomState(4)
    batch = {'image': rng.randint(0, 256, (2, *CANVAS, 3)).astype(np.uint8),
             'img_hw': np.asarray([[64, 96], [56, 80]], np.float32),
             'scale_factor': np.asarray([1.0, 0.75], np.float32)}
    want = jmake_predict_fn(family['jmodel'], cfg, CANVAS)(
        family['variables'], {k: jnp.asarray(v) for k, v in batch.items()})
    got = make_predict_fn(family['model'].eval(), cfg, CANVAS)(batch)
    family['model'].train()
    assert np.asarray(want['valid']).sum() > 0
    for k in ('valid', 'det_labels', 'det_kpts'):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(_np(got['det_bboxes']),
                               np.asarray(want['det_bboxes']), rtol=1e-3,
                               atol=1e-3)


def test_family_state_dict_round_trip(family):
    """port state_dict -> torch_convert -> flax leaves: nothing skipped,
    every leaf present and back as it was (FCOS's scalars back into one
    vector)."""
    params, stats, skipped = convert_state_dict(family['model'].state_dict())
    assert skipped == []
    merged = merge_into_variables(family['variables'], params, stats,
                                  strict=True)
    flat = jax.tree_util.tree_flatten_with_path
    assert len(flat(params)[0]) + len(flat(stats)[0]) == \
        len(flat(family['variables'])[0])
    for (pa, a), (pb, b) in zip(flat(merged)[0],
                                flat(family['variables'])[0]):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_family_pth_routes_accept_and_refuse_as_jax(family):
    """load_reference_state against convert_state_dict +
    merge_into_variables(strict=True), case by case: the model's own
    state loads; GA's reference offset conv of 4 deformable groups (72
    channels) is refused by both with ValueError; FCOS's scales as the
    reference saves them load into the vector's levels in order, and a
    count other than the model's levels is refused by both."""
    model, variables = family['model'], family['variables']
    state = model.state_dict()
    assert load_reference_state(model, dict(state)) == []
    params, stats, skipped = convert_state_dict(dict(state))
    assert skipped == []
    merge_into_variables(variables, params, stats, strict=True)
    if family['cfg'].head.type == 'GARetinaHead':
        bad = {'bbox_head.feature_adaption_cls.conv_offset.weight':
               torch.zeros(72, 2, 1, 1)}
        cases = [(bad, ValueError)]
    else:
        scales = {f'bbox_head.scales.{i}.scale': torch.tensor(1.5 + i)
                  for i in (2, 5, 7)}
        fresh = build_model(family['cfg'], device='cpu')
        load_reference_state(fresh, scales)
        p, _, _ = convert_state_dict(scales)
        np.testing.assert_array_equal(p['head']['scales'], [3.5, 6.5, 8.5])
        for i in range(3):
            assert fresh.bbox_head.scales[i].scale.item() == [3.5, 6.5,
                                                              8.5][i]
        cases = [({k: v for k, v in list(scales.items())[:2]}, ValueError)]
    for bad, err in cases:
        with pytest.raises(err):
            load_reference_state(model, bad)
        p, s, _ = convert_state_dict(bad)
        with pytest.raises(err):
            merge_into_variables(variables, p, s, strict=True)


def test_family_trainer_steps_and_frozen_prefix(family):
    """init_trainer: finite logs, a frozen parameter unchanged, the head's
    output conv moved."""
    cfg = family['cfg']
    model, _, step = init_trainer(cfg, CANVAS, 10, device='cpu')
    free = 'bbox_head.fcos_cls.weight' if cfg.head.type == 'FCOSHead' \
        else 'bbox_head.retina_cls.weight'
    params = dict(model.named_parameters())
    before = {n: params[n].detach().clone()
              for n in (free, 'backbone.layer1.0.conv1.weight')}
    logs = step(synth_batch(canvas=CANVAS, B=2, G=4, K=cfg.head.num_keypts))
    assert all(torch.isfinite(v) for v in logs.values())
    assert torch.equal(params['backbone.layer1.0.conv1.weight'],
                       before['backbone.layer1.0.conv1.weight'])
    assert not torch.equal(params[free], before[free])


def test_registry_errors_and_ga_rpn():
    """get_head_family raises KeyError for an unknown name, as the JAX
    registry; GA-RPN, which raised naming item 6 until it was ported,
    builds with the reference's module names and its loss and proposals
    exist (tests/test_torch_mask_families.py holds them against the JAX
    package)."""
    with pytest.raises(KeyError, match='unknown head family'):
        get_head_family('nope')
    head = GARPNHead(32, 16)
    assert sorted(n for n, _ in head.named_children()) == [
        'conv_cls', 'conv_loc', 'conv_reg', 'conv_shape',
        'feature_adaption', 'rpn_conv']
    assert callable(ga_loss.ga_rpn_loss) and \
        callable(ga_loss.ga_rpn_proposals)
    grids = level_grids(family_cfg('FCOSHead'), CANVAS)
    assert [len(g) for g in grids] == [96, 24, 6]
