"""HTC R-50-FPN (``configs/htc_r50_fpn_1x_deepfashion2.py`` at its widths,
float32, the plain kernels) against the benchmark's plain reference
(``kgbench/reference/htc.py``, ``htc_decode.py``) on the CPU, stage by
stage, with the benchmark's seeded weights: the semantic branch against
the reference's forward, each box stage on the reference's features at
the program's own RoIs for that stage (and those RoIs against the
reference's refinement of the stage before), the averaged mask logits at
the program's mask boxes, and the decode with its masks of the program's
own stage outputs and mask logits. Two images on a 128x192 canvas, 200
proposals and 32 mask RoIs an image (the configuration's 1,000 and 128 take
the plain RoI gathers and the mask heads' twelve 3x3 convs a minute on the
CPU). Stages 2 and 3's mask heads without the information flow fail the
mask comparison.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from kgbench import check_rcnn, serving, weights
from kgbench.reference import htc as ref
from kgbench.reference import htc_decode
from kgdet_tpu_torch.api import build_model, make_predict_fn
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.models import mask_head, two_stage
from kgdet_tpu_torch.ops import plain_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (128, 192)
PROPOSALS = 200
MASK_ROIS = 32
SEED = 2 ** 31 + 26

# float32 on both sides: the convolutions and products sum in another
# order (a relative 1e-6 or so), nothing is rounded to a lower precision
NORM_TOL = 1e-4
# the same float32 operations on the same values: at most a rounding of a
# coordinate, over 1000 px, or of a mask probability; a detection whose
# presence or class differs reads 1
BOX_TOL = 1e-6


def _spec():
    with open(os.path.join(ROOT, 'kgbench', 'configs',
                           'htc_r50_fpn.json')) as f:
        m = json.load(f)['model']
    m['rpn']['max_num'] = PROPOSALS
    m['mask']['rois'] = MASK_ROIS
    return m


def _cfg():
    cfg = load_config(os.path.join(
        ROOT, 'configs', 'htc_r50_fpn_1x_deepfashion2.py'))
    return dataclasses.replace(
        cfg, compute_dtype='float32', num_proposals_test=PROPOSALS,
        test=dataclasses.replace(cfg.test, score_thr=0.0))


def _batch():
    rng = np.random.default_rng(5)
    img_hw = np.asarray([[128, 171], [96, 192]], np.float32)
    image = np.zeros((2,) + CANVAS + (3,), np.uint8)
    for b, (h, w) in enumerate(img_hw.astype(int)):
        image[b, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
    return {'image': image, 'img_hw': img_hw,
            'scale_factor': np.asarray([0.4, 0.3], np.float32)}


def _program(model, cfg, batch):
    """(the forward's outputs, the FPN levels, the semantic branch's
    (logits, embedding), the detections) of one predict call."""
    seen = {}
    hooks = [m.register_forward_hook(
        lambda _m, _a, out, name=name: seen.__setitem__(name, out))
        for name, m in (('fwd', model), ('neck', model.neck),
                        ('sem', model.semantic_head))]
    try:
        with plain_kernels():
            dets = make_predict_fn(model, cfg, CANVAS)(batch)
    finally:
        for h in hooks:
            h.remove()
    return seen['fwd'], list(seen['neck']), seen['sem'], dets


def _stages(fwd):
    return [(s['proposals'], s['roi_cls'], s['roi_reg'])
            for s in fwd['stages']]


@pytest.fixture(scope='module')
def run():
    cfg, m = _cfg(), _spec()
    w = weights.make(ref.param_specs(m), SEED, torch.device('cpu'))
    model = build_model(cfg, device='cpu')
    model.load_state_dict(w, strict=True)
    model.eval()
    batch = _batch()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(two_stage, 'NUM_HEAD_ROIS_TEST', MASK_ROIS)
        fwd, feats, sem, dets = _program(model, cfg, batch)
        x = serving.normalized(batch['image'], batch['img_hw'],
                               m['img_mean'], m['img_std'])
        with torch.no_grad():
            r = ref.forward(w, x, m)
            r['semantic'] = ref.semantic(w, r['feats'], m)
        yield dict(cfg=cfg, m=m, w=w, model=model, batch=batch, fwd=fwd,
                   feats=feats, sem=sem, dets=dets, r=r)


def test_semantic_branch_matches_the_reference(run):
    gap = check_rcnn.norm_gap(list(zip(run['sem'], run['r']['semantic'])))
    assert run['fwd']['semantic_pred'] is run['sem'][0]
    assert gap < NORM_TOL, gap


@pytest.mark.parametrize('stage', [0, 1, 2])
def test_box_stage_matches_the_reference_at_the_programs_rois(run, stage):
    fwd, r, m = run['fwd'], run['r'], run['m']
    rois, cls, reg = _stages(fwd)[stage]
    valid = fwd['proposal_valid']
    with torch.no_grad():
        want = ref.box_stage(run['w'], r['feats'], r['semantic'][1], rois,
                             valid, m, stage)
    gap = check_rcnn.norm_gap([(cls, want[0]), (reg, want[1])])
    assert gap < NORM_TOL, gap
    if stage:                       # the RoIs: the stage before, refined
        prev = _stages(fwd)[stage - 1]
        mine = ref.next_rois(prev[0], prev[2], torch.as_tensor(
            run['batch']['img_hw']), m, stage - 1)
        assert check_rcnn.proposal_gap(rois.numpy(), valid.numpy(),
                                       mine.numpy(), valid.numpy()) <= BOX_TOL


def _mask_gap(run, fwd):
    r = run['r']
    with torch.no_grad():
        want = ref.mask_heads(run['w'], r['feats'], r['semantic'][1],
                              fwd['mask_boxes'], fwd['mask_valid'], run['m'])
    return check_rcnn.norm_gap([(fwd['mask_logits'], want)])


def test_mask_heads_match_the_reference_at_the_programs_mask_boxes(run):
    fwd = run['fwd']
    assert fwd['mask_boxes'].shape[:2] == (2, MASK_ROIS)
    assert bool(fwd['mask_valid'].all())
    gap = _mask_gap(run, fwd)
    assert gap < NORM_TOL, gap


def test_detections_and_masks_match_the_reference_decode(run):
    fwd, b, dets = run['fwd'], run['batch'], run['dets']
    boxes, labels, masks, valid = htc_decode.decode(
        _stages(fwd), fwd['proposal_valid'], fwd['mask_logits'],
        torch.as_tensor(b['img_hw']), torch.as_tensor(b['scale_factor']),
        run['m'], torch.float32)
    assert valid.sum(1).tolist() == [100, 100]
    mine = check_rcnn.valid_rows(boxes, labels, valid)
    gap = check_rcnn.det_gap(check_rcnn.valid_rows(
        *(dets[k].numpy() for k in ('det_bboxes', 'det_labels', 'valid'))),
        mine)
    assert gap <= BOX_TOL, gap
    assert np.array_equal(dets['valid'].numpy(), valid)
    assert np.abs(dets['det_masks'].numpy()[valid]
                  - masks[valid]).max() <= BOX_TOL


def test_mask_heads_without_the_information_flow_fail(run, monkeypatch):
    forward = mask_head.FCNMaskHead.forward

    def no_flow(self, roi_feats, res_feat=None, return_feat=False):
        return forward(self, roi_feats, None, return_feat)
    monkeypatch.setattr(mask_head.FCNMaskHead, 'forward', no_flow)
    with plain_kernels(), torch.no_grad():
        fwd = run['model'].mask_forward(run['feats'], run['sem'][1],
                                        run['fwd'], False)
    assert torch.equal(fwd['mask_boxes'], run['fwd']['mask_boxes'])
    assert _mask_gap(run, fwd) > 100 * NORM_TOL
