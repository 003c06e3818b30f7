"""The HTC cell on the CPU: it resolves by its names alone; its readers
read the observations the driver makes, and nothing on a program without
the spans; K6's least time over HTC's eight gathers, worked by hand; the
mask part of ``det_gap``; a sound run of its driver at a small size is
correct, and the control and the planted faults are not."""
import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from kgbench import check, roofline_htc, spec, traffic
from kgbench.drivers import serve_htc_batches
from kgbench.tests.tiny import ROOT, SIZES

CELL = 'htc_r50_fpn.serve_b8'
CPU = torch.device('cpu')
SEED = 2 ** 31 + 7
CONFIG = os.path.join(ROOT, 'kgbench', 'configs', 'htc_r50_fpn.json')
LIMITS = json.load(open(CONFIG))['limits']


def test_the_cell_resolves_by_its_names():
    cell = spec.load(ROOT, CELL)
    assert cell.chips == 1
    assert cell.traffic['driver'] == 'serve_htc_batches'
    assert {m['name'] for m in cell.end_to_end} == {
        'serve_img_s', 'peak_mem_gib', 'setup_s'}
    assert [m['name'] for m in cell.per_layer] == [
        'nms_ms.serve', 'mfu.serve', 'idle_pct.serve', 'k6_roofline.htc',
        'mask_head_launches.htc', 'mask_head_ms.htc']
    for kind in ('reference', 'decode'):
        cell.module('reference', cell.config[kind])
    assert sorted(cell.config['limits']) == sorted(serve_htc_batches.GAPS)


def test_its_metrics_read_what_the_driver_observes():
    cell = spec.load(ROOT, CELL)
    tl = {'window_s': 0.4, 'busy_s': 0.3, 'calls': 4,
          'kernels_s': {'deform_sample_kernel<bf16>': 0.032, 'gemm': 0.2}}
    pt = {'alone': {'spans': {'mask_head': {'calls': 20, 'mean_ms': 2.5,
                                            'median_ms': 2.25}}},
          'profiled': {'spans': {'mask_head': {'calls': 4,
                                               'launches': 360}}}}
    obs = {'images': 800, 'seconds': 8.0, 'batch': 8,
           'model': cell.config['model'],
           'canvases': [(800, 1344), (1344, 800)], 'timeline': tl,
           'stage_ms': {'decode': [4.0, 6.0]}, 'program_trace': pt,
           'flops_per_image': 9.9e11}
    read = {m['name']: spec.reader(m['name'])(obs) for m in cell.per_layer}
    assert read['nms_ms.serve'] == 5.0
    assert read['idle_pct.serve'] == pytest.approx(25.0)
    assert read['mfu.serve'] == pytest.approx(100 * 100 * 9.9e11 / 989e12)
    assert read['mask_head_launches.htc'] == 90
    assert read['mask_head_ms.htc'] == 2.25
    assert read['k6_roofline.htc'] == pytest.approx(
        100 * roofline_htc.k6_least_seconds(obs['model'], 8,
                                            obs['canvases']) / 0.008)
    del pt['alone']['spans']['mask_head'], pt['profiled']['spans'][
        'mask_head']
    for name in ('mask_head_launches.htc', 'mask_head_ms.htc'):
        assert spec.reader(name)(obs) is None
        assert spec.reader(name)(dict(obs, program_trace=None)) is None


def test_k6_least_time_of_the_eight_gathers_by_hand():
    """A batch of 8 at 800x1344, bf16, 256 channels: the FPN levels hold
    8 x 89,523 cells and the semantic map 8 x 100 x 168; each box stage
    pools 8,000 RoIs at 7 x 7 from both, the mask stage 1,024 at 14 x 14.
    Every gather is bound by its bytes (the samples' 2.8 and 1.4 GFLOP
    take 3 and 1.5 us)."""
    model = json.load(open(CONFIG))['model']
    levels, sem = 8 * 89_523, 8 * 100 * 168
    box_out, mask_out = 8000 * 49, 1024 * 196
    want = 2 * 256 * (3 * (levels + box_out + sem + box_out)
                      + levels + mask_out + sem + mask_out)
    assert want == 3_151_740_928
    gathers = roofline_htc.htc_gathers(model, 8, (800, 1344))
    assert len(gathers) == 8
    assert sum(b for _, b in gathers) == want
    assert gathers[0][0] == 7 * 8000 * 14 * 14 * 256
    assert gathers[-1][0] == 7 * 1024 * 28 * 28 * 256
    assert roofline_htc.htc_gathers(model, 8, (1344, 800)) == gathers
    least = roofline_htc.k6_least_seconds(model, 8,
                                          [(800, 1344), (1344, 800)])
    assert least == pytest.approx(want / 3.35e12)
    assert least == pytest.approx(9.408e-4, rel=1e-3)


def test_det_gap_sees_a_mask_apart():
    rng = np.random.default_rng(2)
    boxes = np.concatenate([rng.uniform(0, 900, (2, 4, 4)),
                            rng.uniform(0, 1, (2, 4, 1))], -1)
    labels = rng.integers(0, 13, (2, 4))
    masks = rng.uniform(0, 1, (2, 4, 28, 28))
    valid = np.ones((2, 4), bool)
    valid[1, 2:] = False
    rows = serve_htc_batches.valid_rows(boxes, labels, masks, valid)
    assert serve_htc_batches.det_gap(rows, serve_htc_batches.valid_rows(
        boxes.copy(), labels.copy(), masks.copy(), valid.copy())) == 0.0
    moved = masks.copy()
    moved[0, 1, 3, 4] += 0.01
    assert serve_htc_batches.det_gap(serve_htc_batches.valid_rows(
        boxes, labels, moved, valid), rows) > LIMITS['det_gap']
    fewer = valid.copy()
    fewer[0, 3] = False
    assert serve_htc_batches.det_gap(serve_htc_batches.valid_rows(
        boxes, labels, masks, fewer), rows) == 1.0


# ------------------------------------------------ the driver, small size
def tiny_cell():
    """The cell on 128x192 canvases, batches of 2, small source images, 100
    proposals an image (so 100 mask RoIs)."""
    cfg = json.load(open(CONFIG))
    data = {'img_scale': [190, 128], 'canvases': [[128, 192], [192, 128]]}
    cfg['overrides'].update({'val_data.img_scale': data['img_scale'],
                             'val_data.canvas_hw': data['canvases'],
                             'num_proposals_test': 100})
    for k in ('val_data.img_scale', 'val_data.canvas_hw',
              'num_proposals_test'):
        cfg['holds'].pop(k)
    cfg['model']['rpn']['max_num'] = 100
    cfg['data'] = data
    mix = json.load(open(os.path.join(ROOT, 'kgbench', 'traffic',
                                      'serve_b8_htc.json')))
    mix.update(sizes=SIZES, batch=2, sampled_batches=1)
    return spec.Cell(root=ROOT, name='tiny', chips=1, config=cfg,
                     traffic=copy.deepcopy(mix))


@pytest.fixture
def first_batch(monkeypatch):
    """The window's first batch is the sampled one, and the window takes
    one batch (seconds 0)."""
    monkeypatch.setattr(traffic, 'sample',
                        lambda seed, items, k: list(items)[:k])


def run():
    return serve_htc_batches.run(tiny_cell(), SEED, 0.0, False,
                                 time.perf_counter(), CPU)


def test_sound_run_is_correct(first_batch):
    res = run()
    readings = {name: v for name, v, _ in res['checks']}
    assert res['correct'], res['checks']
    assert readings['proposal_gap'] == 0.0 and readings['det_gap'] == 0.0
    for name in ('rpn_gap', 'sem_gap', 'stage_gap', 'mask_gap'):
        assert 0 < readings[name] < LIMITS[name]


def test_control_and_planted_faults_are_not_correct(first_batch):
    out = serve_htc_batches.control_readings(tiny_cell(), SEED, CPU)
    correct, rows = check.judge(out['control'], LIMITS)
    assert not correct
    assert out['neighbour_level']['stage_gap'] > LIMITS['stage_gap']
    assert out['no_info_flow']['mask_gap'] > LIMITS['mask_gap']
    assert out['proposals_nms_0.75']['proposal_gap'] > LIMITS['proposal_gap']


def test_mask_heads_without_the_information_flow_are_not_correct(
        first_batch, monkeypatch):
    from kgdet_tpu_torch.models import mask_head
    forward = mask_head.FCNMaskHead.forward

    def no_flow(self, roi_feats, res_feat=None, return_feat=False):
        return forward(self, roi_feats, None, return_feat)
    monkeypatch.setattr(mask_head.FCNMaskHead, 'forward', no_flow)
    res = run()
    readings = {name: v for name, v, _ in res['checks']}
    assert not res['correct'] and readings['mask_gap'] > LIMITS['mask_gap']
