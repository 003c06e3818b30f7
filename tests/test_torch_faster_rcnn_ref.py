"""Faster R-CNN R-50-FPN (``configs/faster_rcnn_r50_fpn_1x_deepfashion2.py``
at its widths, float32, the plain kernels) against the benchmark's plain
reference (``kgbench/reference/faster_rcnn.py``, ``rcnn_decode.py``) on the
CPU, stage by stage, with the benchmark's seeded weights: the RPN's
outputs, the proposals made from the program's RPN outputs, the box head
on the reference's features at the program's proposals, and the decode of
the program's box head outputs. Two images on a 128x192 canvas and 200
proposals an image (the configuration's 1,000 take the plain RoI gather
seconds on the CPU). A RoI taken from its neighbouring level fails the RoI
comparison.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from kgbench import check_rcnn, serving, weights
from kgbench.reference import faster_rcnn as ref
from kgbench.reference import rcnn_decode
from kgdet_tpu_torch.api import build_model, make_predict_fn
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.models import two_stage
from kgdet_tpu_torch.ops import plain_kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (128, 192)
PROPOSALS = 200
SEED = 2 ** 31 + 21

# float32 on both sides: the convolutions and products sum in another
# order (a relative 1e-6 or so), nothing is rounded to a lower precision
NORM_TOL = 1e-4
# the same float32 operations on the same values: at most a rounding of a
# coordinate, over 1000 px; a proposal or detection that differs reads 1
BOX_TOL = 1e-6


def _spec():
    with open(os.path.join(ROOT, 'kgbench', 'configs',
                           'faster_rcnn_r50_fpn.json')) as f:
        m = json.load(f)['model']
    m['rpn']['max_num'] = PROPOSALS
    return m


def _cfg():
    cfg = load_config(os.path.join(
        ROOT, 'configs', 'faster_rcnn_r50_fpn_1x_deepfashion2.py'))
    return dataclasses.replace(
        cfg, compute_dtype='float32', num_proposals_test=PROPOSALS,
        test=dataclasses.replace(cfg.test, score_thr=0.0))


def _batch():
    rng = np.random.default_rng(3)
    img_hw = np.asarray([[128, 171], [96, 192]], np.float32)
    image = np.zeros((2,) + CANVAS + (3,), np.uint8)
    for b, (h, w) in enumerate(img_hw.astype(int)):
        image[b, :h, :w] = rng.integers(0, 256, (h, w, 3), np.uint8)
    return {'image': image, 'img_hw': img_hw,
            'scale_factor': np.asarray([0.4, 0.3], np.float32)}


def _program(model, cfg, batch):
    seen = []
    hook = model.register_forward_hook(lambda _m, _a, out: seen.append(out))
    try:
        dets = make_predict_fn(model, cfg, CANVAS)(batch)
    finally:
        hook.remove()
    return seen[0], dets


@pytest.fixture(scope='module')
def run():
    cfg, m = _cfg(), _spec()
    w = weights.make(ref.param_specs(m), SEED, torch.device('cpu'))
    model = build_model(cfg, device='cpu')
    model.load_state_dict(w, strict=True)
    model.eval()
    batch = _batch()
    with plain_kernels():
        fwd, dets = _program(model, cfg, batch)
    x = serving.normalized(batch['image'], batch['img_hw'], m['img_mean'],
                           m['img_std'])
    with torch.no_grad():
        r = ref.forward(w, x, m)
    return dict(cfg=cfg, m=m, w=w, model=model, batch=batch, fwd=fwd,
                dets=dets, r=r)


def test_rpn_outputs_match_the_reference(run):
    gap = check_rcnn.norm_gap(check_rcnn.rpn_pairs(run['fwd']['rpn_outs'],
                                                   run['r']['rpn']))
    assert gap < NORM_TOL, gap


def test_proposals_match_the_reference_on_the_programs_rpn_outputs(run):
    fwd, m = run['fwd'], run['m']
    rpn = [{k: lvl[k][-1] for k in ('cls', 'bbox')} for lvl in fwd['rpn_outs']]
    props, valid = ref.proposals(
        rpn, ref.anchors(m, CANVAS, 'cpu'),
        torch.as_tensor(run['batch']['img_hw']), m['rpn']['nms_pre'],
        m['rpn']['max_num'], m['rpn']['nms_thr'])
    assert int(valid.sum()) > PROPOSALS         # both images propose
    gap = check_rcnn.proposal_gap(fwd['proposals'].numpy(),
                                  fwd['proposal_valid'].numpy(),
                                  props.numpy(), valid.numpy())
    assert gap <= BOX_TOL, gap


def _roi_gap(run, fwd):
    with torch.no_grad():
        cls, reg = ref.roi_head(run['w'], run['r']['feats'],
                                fwd['proposals'], fwd['proposal_valid'],
                                run['m'])
    return check_rcnn.norm_gap([(fwd['roi_cls'], cls),
                                (fwd['roi_reg'], reg)])


def test_roi_head_matches_the_reference_at_the_programs_proposals(run):
    gap = _roi_gap(run, run['fwd'])
    assert gap < NORM_TOL, gap


def test_detections_match_the_reference_decode(run):
    fwd, b, dets = run['fwd'], run['batch'], run['dets']
    out = rcnn_decode.decode(
        fwd['roi_cls'], fwd['roi_reg'], fwd['proposals'],
        fwd['proposal_valid'], torch.as_tensor(b['img_hw']),
        torch.as_tensor(b['scale_factor']), run['m']['test'], torch.float32)
    mine = check_rcnn.valid_rows(*out)
    assert all(len(boxes) == 100 for boxes, _ in mine)
    gap = check_rcnn.det_gap(check_rcnn.valid_rows(
        *(dets[k].numpy() for k in ('det_bboxes', 'det_labels', 'valid'))),
        mine)
    assert gap <= BOX_TOL, gap


def test_roi_from_its_neighbouring_level_fails_the_comparison(run,
                                                              monkeypatch):
    right = two_stage.map_rois_to_levels

    def neighbour(wh, num_levels, finest_scale=56):
        lvl = right(wh, num_levels, finest_scale)
        return torch.where(lvl < num_levels - 1, lvl + 1, lvl - 1)
    monkeypatch.setattr(two_stage, 'map_rois_to_levels', neighbour)
    fwd, _ = _program(run['model'], run['cfg'], run['batch'])
    assert torch.equal(fwd['proposals'], run['fwd']['proposals'])
    assert _roi_gap(run, fwd) > 100 * NORM_TOL
