"""The port's evaluation path against the JAX package's.

``kgdet_tpu_torch.eval`` (CocoIndex, the COCO / OKS evaluator, the JSON
writer, proposal recall, VOC mAP), ``eval_loop`` (run_inference,
evaluate_results, TTA), ``api.Detector.aug_call`` and the CLI
``tools/test.py`` are held against ``kgdet_tpu`` on the synthetic set of
tests/test_data.py (written as PNGs, with ``num_keypoints`` and one crowd
region added so that both the bbox and the keypoint protocol have work) and
the same weights (flax variables converted with
``utils/convert.py::state_dict_from_jax``). The evaluator and the JSON
files must be equal exactly; detections as tests/test_torch_model.py's
``test_predict_matches_jax`` holds them. One more test runs the CLI in a
process where jax, flax, cv2 and kgdet_tpu cannot be imported.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from kgdet_tpu import eval_loop as jeval_loop
from kgdet_tpu.api import Detector as JDetector
from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.config import load_config as jload_config
from kgdet_tpu.data.dataset import DeepFashion2Dataset as JDataset
from kgdet_tpu.data.loader import DataLoader as JLoader
from kgdet_tpu.eval import coco as jcoco
from kgdet_tpu.eval import cocoeval as jcocoeval
from kgdet_tpu.eval import json_writer as jjson
from kgdet_tpu.eval import mean_ap as jmean_ap
from kgdet_tpu.eval import recall as jrecall
from kgdet_tpu_torch import eval_loop as teval_loop
from kgdet_tpu_torch.api import Detector, build_model
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset as TDataset
from kgdet_tpu_torch.data.loader import DataLoader as TLoader
from kgdet_tpu_torch.eval import coco as tcoco
from kgdet_tpu_torch.eval import cocoeval as tcocoeval
from kgdet_tpu_torch.eval import json_writer as tjson
from kgdet_tpu_torch.eval import mean_ap as tmean_ap
from kgdet_tpu_torch.eval import recall as trecall
from kgdet_tpu_torch.tools import test as ttest
from kgdet_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_data import make_synth_coco
from tests.test_torch_data import assert_same
from tests.test_torch_model import _perturb

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVASES = ((64, 96), (96, 64))
# the head outputs' tolerances of test_head_outputs_match_jax (1e-4, and
# 5e-4 on the moment bbox, in units of the stride), carried through the
# decode to original-image pixels: times the stride (32) over the smallest
# scale factor of the images compared (160 x 120 images at img_scale
# (96, 64): 0.5333; half of it at a half TTA scale)
HEAD_TOL = {'dets': 5e-4, 'kpts': 1e-4}
STRIDE = 32


def det_tol(kind, img_scale_short=64):
    px = STRIDE / (img_scale_short / 120)
    return dict(rtol=HEAD_TOL[kind], atol=HEAD_TOL[kind] * px)

CONFIG_TEXT = '''
from kgdet_tpu.config import (
    BackboneConfig, DataConfig, HeadConfig, KGDetConfig, NeckConfig,
    TestConfig)

_DATA = DataConfig(
    ann_file={ann!r}, img_prefix={prefix!r}, img_scale=(96, 64),
    max_gts=8, batch_size=4, flip_ratio=0.0,
    canvas_hw=((64, 96), (96, 64)))

config = KGDetConfig(
    backbone=BackboneConfig(depth=50, frozen_stages=1),
    neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=64,
                    select_out=(2,), gn_groups=32),
    head=HeadConfig(num_classes=13, in_channels=64, feat_channels=64,
                    point_feat_channels=64, stacked_convs=1,
                    num_keypts=294, gn_groups=8),
    test=TestConfig(nms_pre=50, max_per_class=10, max_per_img=20,
                    score_thr=0.0),
    train_data=_DATA, val_data=_DATA)
'''


def make_eval_set(d, n_images=10, seed=0, landscape_only=False):
    """make_synth_coco's set as PNGs, each annotation with its
    num_keypoints, and a crowd region in the first image; returns the
    annotation file."""
    ann = make_synth_coco(d, n_images=n_images, seed=seed,
                          landscape_only=landscape_only)
    with open(ann) as f:
        coco = json.load(f)
    for im in coco['images']:
        png = im['file_name'].replace('.jpg', '.png')
        cv2.imwrite(os.path.join(d, png),
                    cv2.imread(os.path.join(d, im['file_name'])))
        im['file_name'] = png
    for a in coco['annotations']:
        a['num_keypoints'] = int(np.count_nonzero(
            np.asarray(a['keypoints'])[2::3]))
    coco['annotations'].append({
        'id': 10_000, 'image_id': coco['images'][0]['id'], 'category_id': 3,
        'bbox': [5.0, 5.0, 50.0, 40.0], 'area': 2000.0, 'iscrowd': 1,
        'keypoints': [0.0] * 294 * 3, 'num_keypoints': 0})
    path = os.path.join(d, f'eval_{seed}_{int(landscape_only)}.json')
    with open(path, 'w') as f:
        json.dump(coco, f)
    return path


def write_config(d, ann, name='cfg.py'):
    path = os.path.join(d, name)
    with open(path, 'w') as f:
        f.write(CONFIG_TEXT.format(ann=ann, prefix=d))
    return path


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('torch_eval'))
    cfg_path = write_config(d, make_eval_set(d))
    jcfg, tcfg = jload_config(cfg_path), load_config(cfg_path)
    jmodel = jbuild_model(jcfg)
    variables = _perturb(init_variables(jmodel, jcfg, canvas_hw=CANVASES[0]))
    port = build_model(tcfg, device='cpu')
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    port.eval()
    jds = JDataset(jcfg.val_data, train=False)
    tds = TDataset(tcfg.val_data, train=False)
    want = jeval_loop.run_inference(
        jmodel, variables, jcfg, JLoader(jds, 4, train=False, num_workers=0),
        verbose=False)
    return dict(d=d, cfg_path=cfg_path, jcfg=jcfg, tcfg=tcfg, jmodel=jmodel,
                variables=variables, port=port, jds=jds, tds=tds,
                jresults=want)


def assert_dets_close(got, want, what='', img_scale_short=64):
    """{img_id: (dets, labels, kpts)}: the same images, detections and
    labels; boxes, scores and keypoints within det_tol."""
    assert sorted(got) == sorted(want), what
    for i in want:
        g, w = got[i], want[i]
        assert len(g) == len(w) and g[0].shape == w[0].shape, (what, i)
        np.testing.assert_array_equal(g[1], w[1], err_msg=f'{what} {i}')
        for a, b, k in zip(g[::2], w[::2], ('dets', 'kpts')):
            assert a.dtype == b.dtype
            np.testing.assert_allclose(a, b, err_msg=f'{what} {i} {k}',
                                       **det_tol(k, img_scale_short))


# ---------------------------------------------------------------- evaluator
def _detections(gt_json, kind, seed=0):
    """Per-image (dets (N, 5) xyxy + score, 0-based labels, kpts (N, K*3))
    from the GT: 'perfect' (non-crowd GT, score 1), 'jittered' (GT moved
    by a few pixels, random scores, plus one spurious box an image) or
    'random'."""
    rng = np.random.RandomState(seed)
    cat_ids = sorted(c['id'] for c in gt_json['categories'])
    out, ids = [], []
    for im in gt_json['images']:
        anns = [a for a in gt_json['annotations']
                if a['image_id'] == im['id'] and not a.get('iscrowd', 0)]
        boxes, labels, kpts = [], [], []
        for a in anns:
            x, y, w, h = a['bbox']
            boxes.append([x, y, x + w - 1, y + h - 1, 1.0])
            labels.append(cat_ids.index(a['category_id']))
            kpts.append(np.asarray(a['keypoints'], np.float64))
        boxes = np.asarray(boxes, np.float64).reshape(-1, 5)
        labels = np.asarray(labels, np.int64)
        kpts = np.asarray(kpts, np.float64).reshape(len(anns), -1)
        if kind == 'jittered':
            boxes[:, :4] += rng.uniform(-3, 3, boxes[:, :4].shape)
            boxes[:, 4] = rng.rand(len(boxes))
            kpts[:, 0::3] += rng.normal(0, 2, kpts[:, 0::3].shape)
            kpts[:, 1::3] += rng.normal(0, 2, kpts[:, 1::3].shape)
            boxes = np.concatenate([boxes, [[0, 0, 30, 30, 0.5]]])
            labels = np.concatenate([labels, [rng.randint(13)]])
            kpts = np.concatenate([kpts, rng.uniform(0, 100,
                                                     (1, kpts.shape[1]))])
        elif kind == 'random':
            n = rng.randint(1, 6)
            xy = rng.uniform(0, 100, (n, 2))
            boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (n, 2)),
                                    rng.rand(n, 1)], 1)
            labels = rng.randint(0, 13, n)
            kpts = rng.uniform(0, 150, (n, 294 * 3))
        out.append((boxes.astype(np.float32), labels,
                    kpts.astype(np.float32)))
        ids.append(im['id'])
    return out, ids


@pytest.mark.parametrize('kind', ['perfect', 'jittered', 'random'])
def test_evaluator_and_json_match_jax(setup, tmp_path, kind):
    gt_file = setup['tcfg'].val_data.ann_file
    with open(gt_file) as f:
        gt_json = json.load(f)
    dets, ids = _detections(gt_json, kind)
    cat_ids = sorted(c['id'] for c in gt_json['categories'])
    assert tjson.detections_to_json(dets, ids, cat_ids) == \
        jjson.detections_to_json(dets, ids, cat_ids)
    tfiles = tjson.dump_results(dets, ids, cat_ids, str(tmp_path / 't'))
    jfiles = jjson.dump_results(dets, ids, cat_ids, str(tmp_path / 'j'))
    tgt, jgt = tcoco.CocoIndex(gt_file), jcoco.CocoIndex(gt_file)
    assert tgt.img_ids == jgt.img_ids and tgt.cat_ids == jgt.cat_ids
    for iou_type in ('bbox', 'keypoints'):
        with open(tfiles[iou_type], 'rb') as a, \
                open(jfiles[iou_type], 'rb') as b:
            assert a.read() == b.read(), iou_type
        tdt = tgt.load_results(tfiles[iou_type])
        jdt = jgt.load_results(jfiles[iou_type])
        assert tdt.dataset == jdt.dataset
        tev = tcocoeval.CocoEvaluator(tgt, tdt, iou_type)
        jev = jcocoeval.CocoEvaluator(jgt, jdt, iou_type)
        for ev in (tev, jev):
            ev.evaluate()
            ev.accumulate()
        for k in ('precision', 'recall', 'scores'):
            assert_same(tev.eval[k], jev.eval[k], f'{iou_type} {k}')
        stats = tev.summarize(verbose=False)
        assert stats == jev.summarize(verbose=False)
        if kind == 'perfect':
            assert stats['AP'] == 1.0, (iou_type, stats)
    assert tcocoeval.evaluate_json(gt_file, tfiles, verbose=False) == \
        jcocoeval.evaluate_json(gt_file, jfiles, verbose=False)


def test_iou_and_oks_match_jax():
    rng = np.random.RandomState(0)
    d = rng.uniform(0, 50, (7, 4))
    g = rng.uniform(0, 50, (5, 4))
    crowd = [0, 1, 0, 0, 1]
    assert_same(tcocoeval.bbox_iou_xywh(d, g, crowd),
                jcocoeval.bbox_iou_xywh(d, g, crowd))
    dts = [{'keypoints': rng.uniform(0, 60, 294 * 3).tolist()}
           for _ in range(4)]
    gts = []
    for j in range(3):
        kp = rng.uniform(0, 60, (294, 3))
        kp[:, 2] = (rng.rand(294) > 0.7) * 2 if j else 0
        gts.append({'keypoints': kp.reshape(-1).tolist(),
                    'bbox': [5.0, 6.0, 30.0, 20.0], 'area': 600.0})
    from kgdet_tpu_torch.data.deepfashion2_meta import OKS_SIGMAS
    assert_same(tcocoeval.compute_oks(dts, gts, OKS_SIGMAS),
                jcocoeval.compute_oks(dts, gts, OKS_SIGMAS))


def test_segm_raises_naming_item_6(setup):
    gt = tcoco.CocoIndex(setup['tcfg'].val_data.ann_file)
    seg = [{'image_id': gt.img_ids[0], 'category_id': 1, 'score': 0.5,
            'segmentation': [[0, 0, 10, 0, 10, 10]]}]
    with pytest.raises(NotImplementedError, match='item 6'):
        gt.load_results(seg)
    with pytest.raises(NotImplementedError, match='item 6'):
        teval_loop.evaluate_results(setup['jresults'], setup['tds'],
                                    iou_types=('segm',), verbose=False)


def test_recall_and_mean_ap_match_jax(setup):
    rng = np.random.RandomState(0)
    gts = [rng.uniform(0, 50, (n, 2)) for n in (3, 0, 5)]
    gts = [np.concatenate([g, g + rng.uniform(5, 30, g.shape)], 1)
           for g in gts]
    props = [np.concatenate([np.concatenate([p, p + 20], 1),
                             rng.rand(len(p), 1)], 1)
             for p in (rng.uniform(0, 60, (n, 2)) for n in (40, 10, 0))]
    for mod in ('recall', 'mean_ap'):
        t, j = (trecall, jrecall) if mod == 'recall' else \
            (tmean_ap, jmean_ap)
        assert_same(t.eval_recalls(gts, props, (1, 5, 20), (0.3, 0.5)),
                    j.eval_recalls(gts, props, (1, 5, 20), (0.3, 0.5)))
    assert_same(trecall.bbox_overlaps_np(gts[0], props[0][:, :4]),
                jrecall.bbox_overlaps_np(gts[0], props[0][:, :4]))
    results = setup['jresults']
    t = trecall.eval_proposal_recall(results, setup['tds'], (5, 20),
                                     verbose=False)
    j = jrecall.eval_proposal_recall(results, setup['jds'], (5, 20),
                                     verbose=False)
    assert_same(t, j)
    for mode in ('area', '11points'):
        t = tmean_ap.eval_voc_results(results, setup['tds'], mode=mode)
        j = jmean_ap.eval_voc_results(results, setup['jds'], mode=mode)
        assert t == j
    recalls, precisions = rng.rand(2, 9)
    assert tmean_ap.average_precision(np.sort(recalls), precisions) == \
        jmean_ap.average_precision(np.sort(recalls), precisions)


# ------------------------------------------------------------- eval loop
def test_run_inference_matches_jax_on_both_canvases(setup):
    want = setup['jresults']
    canvases = {s['image'].shape[:2] for s in
                (setup['tds'].prepare_test(i)
                 for i in range(len(setup['tds'])))}
    assert canvases == set(CANVASES)
    timings = {}
    got = teval_loop.run_inference(
        setup['port'], setup['tcfg'],
        TLoader(setup['tds'], 4, train=False, num_workers=2),
        verbose=False, timings=timings)
    assert_dets_close(got, want, 'run_inference')
    assert sum(len(v[0]) for v in got.values()) > 0
    assert timings['images'] >= len(setup['tds'])
    assert timings['batches'] == len(TLoader(setup['tds'], 4, train=False))


def test_run_inference_is_the_predict_fn_unpadded(setup, monkeypatch):
    """The loop adds nothing: each image's detections are what the predict
    function returned for its first batch, cut by ``valid``, copied to the
    host bit for bit (the wrap-padded repeats dropped)."""
    from kgdet_tpu_torch import api
    calls = []

    def recording(model, cfg, canvas):
        predict = api.make_predict_fn(model, cfg, canvas)

        def run(batch):
            out = predict(batch)
            calls.append((batch['img_id'].tolist(),
                          {k: v.clone() for k, v in out.items()}))
            return out
        return run
    monkeypatch.setattr(teval_loop, 'make_predict_fn', recording)
    loader = TLoader(setup['tds'], 4, train=False, num_workers=0)
    got = teval_loop.run_inference(setup['port'], setup['tcfg'], loader,
                                   verbose=False)
    assert len(calls) == len(loader)
    want = {}
    for ids, dets in calls:
        for i, img_id in enumerate(ids):
            v = dets['valid'][i].numpy()
            want.setdefault(img_id, (dets['det_bboxes'][i].numpy()[v],
                                     dets['det_labels'][i].numpy()[v],
                                     dets['det_kpts'][i].numpy()[v]))
    assert sorted(got) == sorted(want) == sorted(
        r.img_id for r in setup['tds'].records)
    for img_id in want:
        assert_same(got[img_id], want[img_id], str(img_id))


def test_unknown_canvas_raises_key_error(setup):
    import dataclasses
    cfg = setup['tcfg']
    one = cfg.replace(val_data=dataclasses.replace(
        cfg.val_data, canvas_hw=(CANVASES[0],)))
    loader = TLoader(setup['tds'], 4, train=False, num_workers=0)
    with pytest.raises(KeyError, match='no predict fn'):
        teval_loop.run_inference(setup['port'], one, loader, verbose=False)


def test_evaluate_results_matches_jax(setup, tmp_path):
    results = setup['jresults']
    t_stats, t_files = teval_loop.evaluate_results(
        results, setup['tds'], str(tmp_path / 't'), verbose=False)
    j_stats, j_files = jeval_loop.evaluate_results(
        results, setup['jds'], str(tmp_path / 'j'), verbose=False)
    assert t_stats == j_stats
    assert sorted(t_files) == sorted(j_files) == ['bbox', 'keypoints']
    for k in t_files:
        with open(t_files[k], 'rb') as a, open(j_files[k], 'rb') as b:
            assert a.read() == b.read(), k
    assert all(np.isfinite(v) for s in t_stats.values() for v in s.values())


def test_gather_is_the_identity_for_one_process(setup):
    r = setup['jresults']
    assert teval_loop.gather_results_across_processes(r) is r


# --------------------------------------------------------------------- TTA
@pytest.fixture(scope='module')
def tta_sets(setup, tmp_path_factory):
    """Four landscape images (one canvas, as tests/test_tta.py)."""
    d = str(tmp_path_factory.mktemp('torch_tta'))
    ann = make_eval_set(d, n_images=4, landscape_only=True)
    cfg_path = write_config(d, ann)
    jcfg, tcfg = jload_config(cfg_path), load_config(cfg_path)
    return (jcfg, JDataset(jcfg.val_data, train=False), tcfg,
            TDataset(tcfg.val_data, train=False))


def test_run_inference_tta_matches_jax(setup, tta_sets):
    """Scales at, below and beyond the canvas buckets (the last builds its
    predict function lazily), with flips, merged before one NMS."""
    jcfg, jds, tcfg, tds = tta_sets
    scales = [(96, 64), (48, 32), (192, 128)]
    want = jeval_loop.run_inference_tta(
        setup['jmodel'], setup['variables'], jcfg, jds, scales=scales,
        flip=True, verbose=False)
    got = teval_loop.run_inference_tta(setup['port'], tcfg, tds,
                                       scales=scales, flip=True,
                                       verbose=False)
    assert_dets_close(got, want, 'tta', img_scale_short=32)
    assert all(np.abs(v[2]).max(initial=0) == 0 for v in got.values())
    t_stats, _ = teval_loop.evaluate_results(got, tds, iou_types=('bbox',),
                                             verbose=False)
    assert np.isfinite(t_stats['bbox']['AP'])


def test_detector_aug_call_matches_jax(setup):
    img = (np.random.RandomState(0).rand(60, 90, 3) * 255).astype(np.uint8)
    jdet = JDetector(setup['jcfg'], setup['variables'])
    tdet = Detector(setup['tcfg'], setup['port'])
    for scales in ([(96, 64)], [(96, 64), (48, 32), (192, 128)]):
        want = jdet.aug_call(img, scales=scales, flip=True, score_thr=0.0)
        got = tdet.aug_call(img, scales=scales, flip=True, score_thr=0.0)
        assert len(got[0]) == len(want[0]) > 0
        np.testing.assert_array_equal(got[1], want[1])
        short = min(s[1] for s in scales)
        np.testing.assert_allclose(got[0], want[0], **det_tol('dets', short))


def test_detector_reads_paths_through_image_io(setup, tmp_path):
    path = str(tmp_path / 'img.png')
    img = (np.random.RandomState(1).rand(60, 90, 3) * 255).astype(np.uint8)
    cv2.imwrite(path, img)
    tdet = Detector(setup['tcfg'], setup['port'])
    from kgdet_tpu_torch.api import inference_detector
    for a, b in zip(inference_detector(tdet, path), tdet(img)):
        assert_same(a, b)


# --------------------------------------------------------------------- CLI
def _copypaste(out, iou_type):
    lines = [ln for ln in out.splitlines()
             if ln.startswith(f'{iou_type}_mAP_copypaste: ')]
    assert len(lines) == 1, out[-2000:]
    return [float(v) for v in lines[0].split(': ')[1].split()]


def test_cli_matches_jax_run_eval(setup, tmp_path, capsys):
    """tools/test.py on a reference-style .pth of the same weights, against
    the JAX package's run_eval."""
    from tests.test_convert import _flax_to_torch_state
    state = _flax_to_torch_state(setup['variables'])
    for k in [k for k in state if k.endswith('.running_mean')]:
        state[k[:-len('running_mean')] + 'num_batches_tracked'] = \
            torch.tensor(0)
    pth = str(tmp_path / 'model.pth')
    torch.save({'state_dict': state}, pth)
    out = ttest.main([setup['cfg_path'], '--load-pth', pth, '--json-out',
                      str(tmp_path / 'port'), '--device', 'cpu'])
    printed = capsys.readouterr().out
    j_stats, j_files = jeval_loop.run_eval(
        setup['jmodel'], setup['variables'], setup['jcfg'], setup['jds'],
        batch_size=4, out_prefix=str(tmp_path / 'jax'), num_workers=0,
        verbose=False)
    assert_dets_close(out['results'], setup['jresults'], 'cli')
    assert sorted(out['files']) == sorted(j_files)
    for iou_type, n in (('bbox', 12), ('keypoints', 10)):
        vals = _copypaste(printed, iou_type)
        assert len(vals) == n and np.isfinite(vals).all()
        want = [round(v, 4) for v in j_stats[iou_type].values()]
        np.testing.assert_allclose(vals, want, atol=1e-3,
                                   err_msg=iou_type)
        assert os.path.exists(out['files'][iou_type])
    assert out['timings']['batches'] == len(
        TLoader(setup['tds'], 4, train=False))


def test_run_eval_matches_jax_run_eval(setup, tmp_path):
    """The port's run_eval (the pipeline tools/test.py shares through
    infer_dataset) against the JAX package's on the same weights."""
    kw = dict(batch_size=4, num_workers=0, verbose=False)
    t_stats, t_files = teval_loop.run_eval(
        setup['port'], setup['tcfg'], setup['tds'],
        out_prefix=str(tmp_path / 'port'), **kw)
    j_stats, j_files = jeval_loop.run_eval(
        setup['jmodel'], setup['variables'], setup['jcfg'], setup['jds'],
        out_prefix=str(tmp_path / 'jax'), **kw)
    assert sorted(t_stats) == sorted(j_stats) == ['bbox', 'keypoints']
    assert sorted(t_files) == sorted(j_files)
    for iou_type in t_stats:
        assert list(t_stats[iou_type]) == list(j_stats[iou_type])
        np.testing.assert_allclose(list(t_stats[iou_type].values()),
                                   list(j_stats[iou_type].values()),
                                   atol=1e-3, err_msg=iou_type)


def test_cli_tta_and_refusals(setup, tmp_path, capsys):
    out = ttest.main([setup['cfg_path'], '--aug', '--aug-scales', '96', '64',
                      '48', '32', '--json-out', str(tmp_path / 'tta'),
                      '--device', 'cpu'])
    vals = _copypaste(capsys.readouterr().out, 'bbox')
    assert len(vals) == 12 and np.isfinite(vals).all()
    assert sorted(out['results']) == sorted(r.img_id
                                            for r in setup['tds'].records)
    with pytest.raises(FileNotFoundError, match='no_such_step'):
        ttest.main([setup['cfg_path'], '--checkpoint',
                    str(tmp_path / 'no_such_step'), '--device', 'cpu'])
    with pytest.raises(NotImplementedError, match='item 4'):
        ttest.main([setup['cfg_path'], '--distributed', '--device', 'cpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            ttest.main([setup['cfg_path']])


def test_cli_runs_without_jax_flax_cv2(setup):
    """The evaluation CLI on PNGs written beforehand, in a process where
    jax, flax, cv2 and kgdet_tpu cannot be imported: the port's own image
    reader and resize, both copypaste lines."""
    code = '\n'.join([
        'import sys',
        "for m in ('jax', 'flax', 'cv2', 'kgdet_tpu'):",
        '    sys.modules[m] = None',
        'import torch',
        'torch.set_num_threads(1)',
        'from kgdet_tpu_torch.data import image_io',
        "print('backend', image_io.BACKEND)",
        'from kgdet_tpu_torch.tools.test import main',
        f"main([{setup['cfg_path']!r}, '--device', 'cpu', '--json-out', "
        f"{os.path.join(setup['d'], 'nocv2')!r}])",
        "print('ok', sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'cv2', 'kgdet_tpu') "
        "and sys.modules[k] is not None))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout
    assert 'backend numpy' in out
    assert len(_copypaste(out, 'bbox')) == 12
    assert len(_copypaste(out, 'keypoints')) == 10
    assert out.strip().splitlines()[-1] == 'ok []'


def test_chip_smoke_png_writer_round_trips_through_cv2(tmp_path):
    """The PNG writer of chip_smoke.py's synthetic sets
    (image_io.write_png): cv2 and the port's own reader give the image
    back bit for bit."""
    from kgdet_tpu_torch.data import image_io
    rng = np.random.RandomState(0)
    for shape in ((37, 53, 3), (8, 1, 3), (1, 8, 3), (1, 1, 3),
                  (90, 130, 3)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        path = str(tmp_path / f'{shape[0]}x{shape[1]}.png')
        image_io.write_png(path, img)
        assert_same(cv2.imread(path, cv2.IMREAD_COLOR), img)
        assert_same(image_io.np_imread(path), img)
