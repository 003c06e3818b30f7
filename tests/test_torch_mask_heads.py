"""The mask families' parts in the port against kgdet_tpu on the CPU,
alone: FCNMaskHead (with and without information flow), MaskIoUHead,
FusedSemanticHead (and its jax.image.resize), GridHead outputs within 1e-4
of scale; mask_targets through the ground truths laid out as channels
against the JAX crops within 1e-5; mask_loss, maskiou_targets,
semantic_loss, grid_targets, grid_loss, grid_refine_boxes; paste_masks
equal; the dataset's polygon rasters and stuff maps against the JAX
dataset; every config file built in the port; the mask path in a process
without jax, flax, cv2 and kgdet_tpu, and the dataset's mask inputs
naming cv2 without it. The detectors themselves are held in
tests/test_torch_mask_families.py."""
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgdet_tpu.config import DataConfig
from kgdet_tpu.data.dataset import DeepFashion2Dataset as JDataset
from kgdet_tpu.models import grid_head as jgrid
from kgdet_tpu.models import mask_head as jmask
from kgdet_tpu.utils.torch_convert import convert_state_dict
from kgdet_tpu_torch.api import build_model
from kgdet_tpu_torch.config import DataConfig as TDataConfig
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset as TDataset
from kgdet_tpu_torch.models import grid_head as tgrid
from kgdet_tpu_torch.models import mask_head as tmask
from kgdet_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_data import make_synth_coco
from tests.test_torch_data import assert_same
from tests.test_torch_mask_families import (HEAD_GAIN, KINDS, ROOT, STUFF,
                                            add_polygons, kind_cfg,
                                            mask_batch)
from tests.test_torch_two_stage_models import _close_scaled, _np

torch.set_num_threads(1)


# ------------------------------------------------------- heads and functions
def _head_pair(jhead, x_args, tmodule, key, prefix, **apply_kw):
    """Init a flax head on x_args, carry its params into ``tmodule`` under
    ``prefix`` through state_dict_from_jax; returns (variables,
    tmodule)."""
    v = jhead.init(jax.random.PRNGKey(key), *x_args, **apply_kw)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a) * HEAD_GAIN
                               if a.ndim == 4 else np.asarray(a), v)
    sd = state_dict_from_jax({'params': {prefix: v['params']}})
    tmodule.load_state_dict({k[len(prefix) + 1:]: t for k, t in sd.items()},
                            strict=True)
    return v, tmodule


@pytest.mark.parametrize('info_flow', [False, True])
def test_fcn_mask_head_matches_jax(info_flow):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 14, 14, 32).astype(np.float32)
    res = rng.randn(5, 14, 14, 48).astype(np.float32) if info_flow else None
    jhead = jmask.FCNMaskHead(num_classes=7, conv_channels=48,
                              with_info_flow=info_flow)
    v, head = _head_pair(jhead, (jnp.asarray(x),), tmask.FCNMaskHead(
        7, 32, 48, with_info_flow=info_flow), 1, 'mask_head',
        res_feat=None if res is None else jnp.asarray(res))
    want, wfeat = jhead.apply(v, jnp.asarray(x), res_feat=None if res is None
                              else jnp.asarray(res), return_feat=True)
    got, gfeat = head(torch.from_numpy(x), None if res is None
                      else torch.from_numpy(res), return_feat=True)
    assert tuple(got.shape) == (5, 28, 28, 7)
    _close_scaled(got.detach(), want, 1e-4)
    _close_scaled(gfeat.detach(), wfeat, 1e-4)
    assert np.abs(np.asarray(want)).max() > 1e-3


def test_maskiou_head_matches_jax():
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 3, 14, 14, 16).astype(np.float32)
    pred = rng.randn(2, 3, 28, 28).astype(np.float32) * 3
    jhead = jmask.MaskIoUHead(num_classes=5, conv_channels=32,
                              fc_channels=64)
    v, head = _head_pair(jhead, (jnp.asarray(feats), jnp.asarray(pred)),
                         tmask.MaskIoUHead(5, 16, 32, 64), 2,
                         'mask_iou_head')
    want = jhead.apply(v, jnp.asarray(feats), jnp.asarray(pred))
    got = head(torch.from_numpy(feats), torch.from_numpy(pred))
    assert tuple(got.shape) == (2, 3, 5)
    _close_scaled(got.detach(), want, 1e-4)


@pytest.mark.parametrize('n_in,n_out', [(50, 25), (13, 25), (7, 25),
                                        (25, 25), (9, 4), (3, 10)])
def test_resize_matches_jax_image_resize(n_in, n_out):
    """The semantic head's resize: jax.image.resize 'bilinear' (with its
    antialiasing when shrinking), both axes."""
    x = np.random.RandomState(n_in).randn(2, n_in, n_in + 3, 4) \
        .astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, n_out, n_out + 1, 4),
                            method='bilinear')
    got = tmask.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2),
                                (n_out, n_out + 1)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fused_semantic_head_matches_jax():
    rng = np.random.RandomState(3)
    sizes = ((24, 36), (12, 18), (6, 9), (3, 5), (2, 3))
    feats = [rng.randn(2, h, w, 16).astype(np.float32) for h, w in sizes]
    jhead = jmask.FusedSemanticHead(num_ins=5, conv_channels=16,
                                    num_classes=STUFF)
    v, head = _head_pair(jhead, ([jnp.asarray(f) for f in feats],),
                         tmask.FusedSemanticHead(5, 1, 4, 16, 16, STUFF), 3,
                         'semantic_head')
    want = jhead.apply(v, [jnp.asarray(f) for f in feats])
    got = head([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        _close_scaled(g.detach(), w, 1e-4)


@pytest.mark.parametrize('train', [True, False])
def test_grid_head_matches_jax(train):
    x = np.random.RandomState(4).randn(3, 14, 14, 32).astype(np.float32)
    jhead = jgrid.GridHead()
    v = jhead.init(jax.random.PRNGKey(5), jnp.asarray(x))
    head = tgrid.GridHead(in_channels=32)
    sd = state_dict_from_jax({'params': {'grid_head': v['params']}})
    head.load_state_dict({k[len('grid_head.'):]: t for k, t in sd.items()},
                         strict=True)
    want = jhead.apply(v, jnp.asarray(x), train=train)
    got = head(torch.from_numpy(x), train=train)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (3, 28, 28, 9)
        _close_scaled(g.detach(), w, 1e-4)


def _boxes(rng, B, R, hw):
    xy = rng.uniform(-4, [hw[1] - 8, hw[0] - 8], (B, R, 2))
    wh = rng.uniform(1, 40, (B, R, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_mask_targets_match_jax_crops():
    """The ground truths as channels of one map, gathered once: equal to
    the JAX package's RoIAlign over B * G one-channel maps within 1e-5."""
    rng = np.random.RandomState(5)
    B, G, R = 2, 5, 11
    masks = (rng.rand(B, G, 16, 24) > 0.5).astype(np.float32)
    assigned = rng.randint(0, G, (B, R)).astype(np.int32)
    props = _boxes(rng, B, R, (64, 96))
    want = jmask.mask_targets(jnp.asarray(masks), jnp.asarray(assigned),
                              jnp.asarray(props), 4)
    got = tmask.mask_targets(torch.from_numpy(masks),
                             torch.from_numpy(assigned),
                             torch.from_numpy(props), 4)
    assert tuple(got.shape) == (B, R, 28, 28)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.asarray(want).max() > 0.5


def _fn_cases(rng):
    B, R, S, C = 2, 6, 28, 7
    logits = rng.randn(B, R, S, S, C).astype(np.float32) * 3
    targets = rng.rand(B, R, S, S).astype(np.float32)
    labels = rng.randint(0, C + 1, (B, R)).astype(np.int32)
    pos = (rng.rand(B, R) > 0.4).astype(np.float32)
    seg = rng.randint(0, 9, (B, 5, 7)).astype(np.int32)
    seg[0, 0] = 255
    sem = rng.randn(B, 5, 7, 8).astype(np.float32)
    props = _boxes(rng, 1, 12, (64, 96))[0]
    gts = props + rng.randn(12, 4).astype(np.float32) * 4
    heat = rng.randn(12, 28, 28, 9).astype(np.float32) * 3
    hw = (rng.rand(12) > 0.3).astype(np.float32)
    return {
        'mask_loss': ((logits, targets, labels, pos), {}),
        'maskiou_targets': ((logits[..., 0], targets), {}),
        'semantic_loss': ((sem, seg), {}),
        'grid_targets': ((props, gts), {}),
        'grid_loss': ((heat, heat[::-1] * 0.5,
                       (rng.rand(12, 28, 28, 9) > 0.9).astype(np.float32),
                       hw), {}),
        'grid_refine_boxes': ((heat, props), {}),
    }


@pytest.mark.parametrize('fn', ['mask_loss', 'maskiou_targets',
                                'semantic_loss', 'grid_targets',
                                'grid_loss', 'grid_refine_boxes'])
def test_losses_and_targets_match_jax(fn):
    args, kw = _fn_cases(np.random.RandomState(6))[fn]
    jmod, tmod = (jgrid, tgrid) if fn.startswith('grid') \
        else (jmask, tmask)
    want = getattr(jmod, fn)(*[jnp.asarray(a) for a in args], **kw)
    got = getattr(tmod, fn)(*[torch.from_numpy(np.ascontiguousarray(a))
                              for a in args], **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == bool or fn == 'grid_targets':
            np.testing.assert_array_equal(_np(g), w)
        else:
            np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-5)
    if fn == 'grid_targets':
        assert np.asarray(want[0]).sum() > 0


def test_paste_masks_equal():
    rng = np.random.RandomState(7)
    boxes = np.concatenate([_boxes(rng, 1, 9, (90, 130))[0],
                            [[-5, -5, 140, 100], [120, 80, 128, 88]]])
    probs = rng.rand(len(boxes), 28, 28).astype(np.float32)
    got = tmask.paste_masks(boxes, probs, 90, 130)
    want = jmask.paste_masks(boxes, probs, 90, 130)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same(g, w)


# ------------------------------------------------------------------ dataset
def test_mask_rasters_and_stuff_maps_match_jax_dataset(tmp_path):
    """gt_masks and gt_semantic_seg of the port's dataset equal to the JAX
    dataset's, in training (with flips) and at test."""
    d = str(tmp_path)
    ann = add_polygons(make_synth_coco(d, n_images=6), os.path.join(d, 'seg'))
    kw = dict(ann_file=ann, img_prefix=d, img_scale=(128, 96),
              canvas_hw=((96, 128), (128, 96)), with_mask=True,
              mask_stride=4, seg_prefix=os.path.join(d, 'seg'),
              seg_stride=8, max_gts=4, flip_ratio=0.5)
    jds = JDataset(DataConfig(**kw), train=True)
    tds = TDataset(TDataConfig(**kw), train=True)
    for idx in range(len(tds)):
        for seed in (0, 1):
            got = tds.prepare_train(idx, np.random.RandomState(seed))
            want = jds.prepare_train(idx, np.random.RandomState(seed))
            assert_same(got, want)
            assert got['gt_masks'].shape == (4, 24, 32) or \
                got['gt_masks'].shape == (4, 32, 24)
            assert got['gt_masks'].any() and (got['gt_semantic_seg'] < 255) \
                .any()


# ------------------------------------------------------------- config files
CONFIGS = sorted(os.path.basename(p)[:-3]
                 for p in glob.glob(os.path.join(ROOT, 'configs', '*.py')))


@pytest.mark.parametrize('name', CONFIGS)
def test_every_config_file_builds_in_the_port(name):
    """Each of the 17 config files as it ships builds in the port on the
    CPU, the JAX package's class for its type; the three mask configs'
    state_dicts go through the JAX converter with nothing skipped."""
    assert len(CONFIGS) == 17
    from kgdet_tpu.api import build_model as jbuild
    from kgdet_tpu.config import load_config as jload_config
    path = os.path.join(ROOT, 'configs', f'{name}.py')
    cfg = load_config(path)
    model = build_model(cfg, device='cpu')
    assert type(model).__name__ == type(jbuild(jload_config(path))).__name__
    if cfg.detector_type in ('mask_rcnn', 'ms_rcnn', 'htc'):
        _, _, skipped = convert_state_dict(model.state_dict())
        assert skipped == []
        assert cfg.train_data.with_mask
        heads = {n for n, _ in model.named_children()}
        assert 'mask_head' in heads
        assert ('mask_iou_head' in heads) == (cfg.detector_type == 'ms_rcnn')
        assert ('semantic_head' in heads) == (cfg.detector_type == 'htc')


def test_mask_path_runs_without_jax_flax_cv2(tmp_path):
    """In a process where jax, flax, cv2 and kgdet_tpu cannot be imported:
    the three mask configs load; a tiny Mask R-CNN, Mask Scoring R-CNN,
    HTC, Grid R-CNN and GA-RPN Faster R-CNN serve a batch (with masks) and
    take a train step (masks and stuff maps in the batch); the RLE code
    builds and encodes; the paths that need cv2 (pasting masks, filling
    polygons, reading stuff maps) raise naming cv2."""
    batches = {}
    for kind in KINDS:
        batches[kind] = {k: v for k, v in mask_batch(kind_cfg(kind)).items()}
    np.savez(tmp_path / 'batches.npz', **{
        f'{kind}/{k}': v for kind, b in batches.items() for k, v in
        b.items()})
    # 8 proposals an image: what runs does not depend on their count
    reprs = {kind: repr(kind_cfg(kind).replace(num_proposals_train=8,
                                               num_proposals_test=8))
             for kind in KINDS}
    code = '\n'.join([
        'import glob, sys',
        "for m in ('jax', 'flax', 'cv2', 'kgdet_tpu'):",
        '    sys.modules[m] = None',
        'import numpy as np, torch',
        'torch.set_num_threads(1)',
        'from kgdet_tpu_torch.config import *',
        'from kgdet_tpu_torch.config import load_config',
        'from kgdet_tpu_torch.api import build_model, init_trainer, '
        'make_predict_fn',
        'for name in ("mask_rcnn", "ms_rcnn", "htc"):',
        '    load_config(f"configs/{name}_r50_fpn_1x_deepfashion2.py")',
        f"data = np.load({str(tmp_path / 'batches.npz')!r})",
        f'cfgs = {{k: eval(v) for k, v in {reprs!r}.items()}}',
        'for kind, cfg in cfgs.items():',
        '    cfg = cfg.replace(test=cfg.test.__class__(nms_pre=50, '
        'max_per_class=10, max_per_img=20, score_thr=0.0))',
        "    model = build_model(cfg, device='cpu').init_weights(0).eval()",
        "    batch = {'image': np.zeros((2, 64, 96, 3), np.uint8), "
        "'img_hw': np.array([[64, 96], [60, 90]], np.float32), "
        "'scale_factor': np.ones(2, np.float32)}",
        '    dets = make_predict_fn(model, cfg, (64, 96))(batch)',
        "    assert dets['valid'].any()",
        "    assert ('det_masks' in dets) == (kind in ('mask', 'ms', 'htc'))",
        "    model, opt, step = init_trainer(cfg, (64, 96), 10, "
        "device='cpu')",
        "    b = {k.split('/')[1]: data[k] for k in data.files "
        "if k.startswith(kind + '/')}",
        "    logs = step(dict(b, seed=np.int32(1)))",
        "    assert torch.isfinite(logs['loss']), kind",
        'from kgdet_tpu_torch.native import RLE',
        'm = np.zeros((7, 9), np.uint8); m[2:5, 3:8] = 1',
        'assert RLE.encode(m).area() == 15',
        'from kgdet_tpu_torch.models.mask_head import paste_masks',
        'try:',
        '    paste_masks(np.ones((1, 4)), np.ones((1, 28, 28)), 9, 9)',
        "    raise SystemExit('paste_masks without cv2')",
        'except ImportError as e:',
        "    assert 'cv2' in str(e), e",
        'from kgdet_tpu_torch.data import image_io',
        'try:',
        "    image_io.require_cv2('filling polygons')",
        "    raise SystemExit('require_cv2 without cv2')",
        'except ImportError as e:',
        "    assert 'cv2' in str(e), e",
        "print('ok', sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'cv2', 'kgdet_tpu') and sys.modules[k] is not "
        "None))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == 'ok []'


def test_dataset_mask_inputs_raise_naming_cv2_without_it(tmp_path,
                                                         monkeypatch):
    """Without cv2 the dataset's polygon rasters and stuff maps raise
    ImportError naming it (the port has no own code for them)."""
    from kgdet_tpu_torch.data import image_io
    d = str(tmp_path)
    ann = add_polygons(make_synth_coco(d, n_images=2), os.path.join(d, 'seg'))
    monkeypatch.setattr(image_io, 'cv2', None)
    for kw in (dict(with_mask=True), dict(seg_prefix=os.path.join(d, 'seg'))):
        ds = TDataset(TDataConfig(ann_file=ann, img_prefix=d,
                                  img_scale=(128, 96),
                                  canvas_hw=((96, 128), (128, 96)), **kw),
                      train=False)
        record = ds.records[0]
        with pytest.raises(ImportError, match='cv2'):
            if 'with_mask' in kw:
                ds.rasterize_masks(record.img_id, 1.0, None, (96, 128))
            else:
                ds._semantic_seg(record, 1.0, False, (96, 128))


def _shard_fwd(x, sl, level=False):
    """A forward dict's tensors sliced to the images ``sl`` (the RPN's
    per-level maps carry a leading stage axis; the anchors are shared)."""
    if isinstance(x, dict):
        return {k: v if k == 'anchors' else
                _shard_fwd(v, sl, level or k == 'rpn_outs')
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_shard_fwd(v, sl, level) for v in x]
    if torch.is_tensor(x) and x.dim():
        return x[:, sl] if level else x[sl]
    return x


@pytest.mark.parametrize('kind', KINDS)
def test_two_shards_with_global_counts_add_up_to_the_batch(kind,
                                                            monkeypatch):
    """The data-parallel convention of the mask, mask-IoU, grid, semantic
    and GA-RPN terms without a process group: one forward of a batch of 4
    cut into two shards of 2 (with their gt_masks and stuff maps); a first
    pass records every count each shard hands ``global_sum``, a second has
    ``global_sum`` return that count summed over both shards. The shards'
    terms then add up to the whole batch's within 1e-5, as two processes'
    summed losses do."""
    from kgdet_tpu_torch.core import ga_loss as tga
    from kgdet_tpu_torch.core import two_stage_loss as tsl
    from kgdet_tpu_torch.parallel.train import two_stage_valid_flags
    cfg = kind_cfg(kind)
    canvas = (64, 96)
    model = build_model(cfg, device='cpu').init_weights(0)
    with torch.no_grad():                 # as the detector tests scale them
        for name, p in model.named_parameters():
            if name.startswith(('mask_head', 'semantic_head',
                                'mask_iou_head')) and p.dim() == 4:
                p.mul_(HEAD_GAIN)
    b2 = [mask_batch(cfg, seed=s) for s in (0, 1)]
    batch = {k: torch.as_tensor(np.concatenate([b[k] for b in b2]))
             for k in b2[0]}
    with torch.no_grad():
        fwd = model(batch['image'], batch['valid_hw'].float(), train=True)
    n = {tsl.RPN_ROLE: sum(o['cls'].shape[2] * o['cls'].shape[3]
                           * o['cls'].shape[4] for o in fwd['rpn_outs']),
         **{tsl.rcnn_role(i): fwd['proposals'].shape[1] for i in range(3)}}
    gen = torch.Generator().manual_seed(0)
    uni = {r: torch.rand((4, 4, c), generator=gen) for r, c in n.items()}
    if cfg.rpn_type == 'ga_rpn':
        p = sum(o['cls'].shape[2] * o['cls'].shape[3]
                for o in fwd['rpn_outs'])
        uni[tsl.RPN_ROLE] = torch.rand((4, 4, p), generator=gen)
    loss = tsl.two_stage_loss_fn(cfg.detector_type)
    modules = (tsl, tga, tmask, tgrid)

    def run(sl):
        f, b = _shard_fwd(fwd, sl), {k: v[sl] for k, v in batch.items()}
        valids = two_stage_valid_flags(
            cfg, b['valid_hw'], [o['cls'].shape[2:4] for o in
                                 f['rpn_outs']])
        return loss(f, b, lambda role, c: uni[role][sl][..., :c], cfg,
                    valids, canvas_hw=canvas)

    seen = [[], []]
    for i, sl in enumerate((slice(0, 2), slice(2, 4))):
        def record(t, i=i):
            seen[i].append(t.detach().clone())
            return t
        for mod in modules:
            monkeypatch.setattr(mod, 'global_sum', record)
        run(sl)
    assert len(seen[0]) == len(seen[1]) >= 3
    totals = [a + b for a, b in zip(*seen)]
    parts = []
    for sl in (slice(0, 2), slice(2, 4)):
        calls = iter(totals)
        for mod in modules:
            monkeypatch.setattr(mod, 'global_sum', lambda t: next(calls))
        parts.append(run(sl))
    monkeypatch.undo()
    whole, wlogs = run(slice(0, 4))
    np.testing.assert_allclose(parts[0][0].item() + parts[1][0].item(),
                               whole.item(), rtol=1e-5)
    own = {'mask': 'loss_mask', 'ms': 'loss_mask_iou',
           'htc': 'loss_mask_s1', 'grid': 'loss_grid',
           'ga': 'loss_anchor_shape'}[kind]
    assert wlogs[own] > 0, {k: v.item() for k, v in wlogs.items()}
    for k in wlogs:
        np.testing.assert_allclose(parts[0][1][k].item()
                                   + parts[1][1][k].item(),
                                   wlogs[k].item(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize('kind', ['mask', 'htc'])
def test_train_and_test_clis_take_a_mask_config(kind, tmp_path, capsys):
    """tools/train.py --validate on a tiny Mask R-CNN or HTC (stuff maps
    from seg_prefix) over 6 PNGs with polygons, batch 2, one epoch, then
    tools/test.py --checkpoint --eval bbox segm on its last step: finite
    records with the family's mask terms, a checkpoint, the bbox and segm
    copypaste lines, a segm result an image with detections."""
    import dataclasses
    import json

    from kgdet_tpu.config import DataConfig as JDataConfig
    from kgdet_tpu_torch.tools import test as ttest
    from kgdet_tpu_torch.tools import train as ttrain_cli
    from tests.test_torch_dist import write_port_config
    from tests.test_torch_eval import make_eval_set
    d = str(tmp_path)
    seg = os.path.join(d, 'seg')
    ann = add_polygons(make_eval_set(d, n_images=6, landscape_only=True),
                       seg)
    cfg = kind_cfg(kind).replace(num_proposals_train=8,
                                 num_proposals_test=8)
    data = dict(ann_file=ann, img_prefix=d, img_scale=(96, 64),
                batch_size=2, canvas_hw=((64, 96),), with_mask=True,
                mask_stride=4, max_gts=4)
    train = dict(data, seg_prefix=seg, seg_stride=16) if kind == 'htc' \
        else data
    cfg = cfg.replace(train_data=JDataConfig(**train),
                      val_data=JDataConfig(**data),
                      test=dataclasses.replace(cfg.test, score_thr=0.0))
    path = write_port_config(str(tmp_path / 'cfg.py'), cfg)
    work = str(tmp_path / 'work')
    runner = ttrain_cli.main([path, '--work-dir', work, '--device', 'cpu',
                              '--max-epochs', '1', '--validate',
                              '--log-interval', '1'])
    printed = capsys.readouterr().out
    assert runner.step == 3
    assert os.listdir(os.path.join(work, 'checkpoints')) == ['3']
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    train_recs = [r for r in recs if r['mode'] == 'train']
    own = 'loss_mask' if kind == 'mask' else 'loss_semantic_seg'
    assert len(train_recs) == 3 and all(own in r for r in train_recs)
    assert all(np.isfinite(v) for r in recs for v in r.values()
               if not isinstance(v, str))
    assert 'bbox_mAP_copypaste: ' in printed
    out = ttest.main([path, '--device', 'cpu', '--checkpoint',
                      os.path.join(work, 'checkpoints', '3'), '--eval',
                      'bbox', 'segm', '--json-out', str(tmp_path / 'res')])
    printed = capsys.readouterr().out
    for iou_type in ('bbox', 'segm'):
        assert f'{iou_type}_mAP_copypaste: ' in printed
    with open(out['files']['segm']) as f:
        segm = json.load(f)
    assert {r['image_id'] for r in segm} == {
        i for i, r in out['results'].items() if len(r[0])}
    assert segm and all(len(r) == 4 for r in out['results'].values())
