"""The Faster R-CNN cell on the CPU: it resolves by its names alone; each of
its four compared numbers reads 0 on identical inputs and fails on a
planted fault, on tiny tensors; a sound run of its driver at a small size
is correct, and the control and a fault planted in the timed path are
not."""
import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from kgbench import check, check_rcnn, roofline_rcnn, spec, traffic
from kgbench.drivers import serve_rcnn_batches
from kgbench.tests.tiny import ROOT, SIZES

CELL = 'faster_rcnn_r50_fpn.serve_b8'
CPU = torch.device('cpu')
SEED = 2 ** 31 + 7
LIMITS = json.load(open(os.path.join(
    ROOT, 'kgbench', 'configs', 'faster_rcnn_r50_fpn.json')))['limits']


def test_the_cell_resolves_by_its_names():
    cell = spec.load(ROOT, CELL)
    assert cell.traffic['driver'] == 'serve_rcnn_batches'
    assert {m['name'] for m in cell.end_to_end} == {
        'serve_img_s', 'peak_mem_gib', 'setup_s'}
    assert [m['name'] for m in cell.per_layer] == [
        'nms_ms.serve', 'mfu.serve', 'idle_pct.serve', 'k6_roofline.rcnn',
        'proposals_launches.rcnn']
    assert cell.module('drivers', 'serve_rcnn_batches') is serve_rcnn_batches
    for kind in ('reference', 'decode'):
        cell.module('reference', cell.config[kind])
    assert sorted(cell.config['limits']) == sorted(serve_rcnn_batches.GAPS)


def test_its_metrics_read_what_the_driver_observes():
    """The traced observations as the driver fills them (two batches of a
    stretch): each per-layer metric of the cell reads a number, and
    ``proposals_launches.rcnn`` none on a program without the span."""
    cell = spec.load(ROOT, CELL)
    tl = {'window_s': 0.1, 'busy_s': 0.08, 'calls': 2,
          'kernels_s': {'deform_sample_kernel<bf16>': 0.003, 'gemm': 0.02}}
    obs = {'images': 800, 'seconds': 5.0, 'batch': 8,
           'model': cell.config['model'],
           'canvases': [(800, 1344), (1344, 800)], 'timeline': tl,
           'stage_ms': {'decode': [7.0, 9.0]},
           'program_trace': {'profiled': {'spans': {
               'proposals': {'calls': 2, 'launches': 726}}}},
           'flops_per_image': 4.3e11}
    read = {m['name']: spec.reader(m['name'])(obs) for m in cell.per_layer}
    assert read['nms_ms.serve'] == 8.0
    assert read['idle_pct.serve'] == pytest.approx(20.0)
    assert read['mfu.serve'] == pytest.approx(100 * 160 * 4.3e11 / 989e12)
    assert read['proposals_launches.rcnn'] == 363
    assert read['k6_roofline.rcnn'] == pytest.approx(
        100 * roofline_rcnn.k6_least_seconds(obs['model'], 8,
                                             obs['canvases']) / 0.0015)
    obs['program_trace'] = None
    assert spec.reader('proposals_launches.rcnn')(obs) is None


def test_k6_least_time_counts_compulsory_bytes():
    """Each level's map read once and the pooled 7 x 7 x 256 output of
    every proposal slot written, at bfloat16: 0.169 ms a batch of 8 at
    3.35 TB/s, on either canvas (the bilinear operations, 2.8 GFLOP, take
    under 3 us at the peak)."""
    model = json.load(open(os.path.join(
        ROOT, 'kgbench', 'configs', 'faster_rcnn_r50_fpn.json')))['model']
    ops, n_bytes = roofline_rcnn.k6_work(model, 8, (800, 1344))
    maps = 8 * 256 * (200 * 336 + 100 * 168 + 50 * 84 + 25 * 42 + 13 * 21)
    assert n_bytes == 2 * (maps + 8 * 1000 * 7 * 7 * 256)
    assert ops == 7 * 8 * 1000 * 7 * 7 * 4 * 256
    assert roofline_rcnn.k6_work(model, 8, (1344, 800)) == (ops, n_bytes)
    least = roofline_rcnn.k6_least_seconds(model, 8,
                                           [(800, 1344), (1344, 800)])
    assert least == pytest.approx(n_bytes / 3.35e12)
    assert least == pytest.approx(1.694e-4, rel=1e-3)


def _levels(seed):
    g = torch.Generator().manual_seed(seed)
    return [{'cls': torch.randn(2, h, w, 3, generator=g),
             'bbox': torch.randn(2, h, w, 12, generator=g)}
            for h, w in ((8, 12), (4, 6))]


def test_rpn_and_roi_gaps_are_zero_on_identical_inputs_and_see_a_fault():
    ref = _levels(0)
    same = [{k: v.clone()[None] for k, v in lvl.items()} for lvl in ref]
    assert check_rcnn.norm_gap(check_rcnn.rpn_pairs(same, ref)) == 0.0
    same[1]['bbox'] = same[1]['bbox'] * 1.5        # one output scaled
    gap = check_rcnn.norm_gap(check_rcnn.rpn_pairs(same, ref))
    assert gap > LIMITS['rpn_gap'] and gap > LIMITS['roi_gap']
    cls = torch.randn(2, 5, 14)
    assert check_rcnn.norm_gap([(cls.clone(), cls)]) == 0.0
    assert check_rcnn.norm_gap([(cls.roll(1, 1), cls)]) > LIMITS['roi_gap']
    assert check_rcnn.norm_gap([(cls[:1], cls)]) == float('inf')


def test_proposal_gap_is_zero_on_identical_inputs_and_sees_a_fault():
    props = np.random.default_rng(0).uniform(0, 500, (2, 6, 4))
    valid = np.ones((2, 6), bool)
    valid[1, 4:] = False
    assert check_rcnn.proposal_gap(props, valid, props.copy(),
                                   valid.copy()) == 0.0
    moved = props.copy()
    moved[0, 2, 1] += 2.0                               # 2 px
    assert check_rcnn.proposal_gap(moved, valid, props, valid) \
        > LIMITS['proposal_gap']
    dropped = valid.copy()
    dropped[0, 5] = False
    assert check_rcnn.proposal_gap(props, dropped, props, valid) == 1.0


def test_det_gap_is_zero_on_identical_inputs_and_sees_a_fault():
    rng = np.random.default_rng(1)
    boxes = np.concatenate([rng.uniform(0, 900, (2, 5, 4)),
                            rng.uniform(0, 1, (2, 5, 1))], -1)
    labels = rng.integers(0, 13, (2, 5))
    valid = np.ones((2, 5), bool)
    valid[0, 3:] = False
    rows = check_rcnn.valid_rows(boxes, labels, valid)
    assert check_rcnn.det_gap(rows, check_rcnn.valid_rows(
        boxes.copy(), labels.copy(), valid.copy())) == 0.0
    scored = boxes.copy()
    scored[1, 0, 4] += 0.01
    assert check_rcnn.det_gap(check_rcnn.valid_rows(scored, labels, valid),
                              rows) > LIMITS['det_gap']
    relabelled = labels.copy()
    relabelled[1, 2] = (relabelled[1, 2] + 1) % 13
    assert check_rcnn.det_gap(check_rcnn.valid_rows(
        boxes, relabelled, valid), rows) == 1.0


# ------------------------------------------------ the driver, small size
def tiny_cell():
    """The cell on 128x192 canvases, batches of 2, small source images, 100
    proposals an image (the plain RoI gather of 1,000 takes seconds on the
    CPU)."""
    root = os.path.join(ROOT, 'kgbench')
    cfg = json.load(open(os.path.join(root, 'configs',
                                      'faster_rcnn_r50_fpn.json')))
    data = {'img_scale': [190, 128], 'canvases': [[128, 192], [192, 128]]}
    cfg['overrides'].update({'val_data.img_scale': data['img_scale'],
                             'val_data.canvas_hw': data['canvases']})
    for k in ('img_scale', 'canvas_hw'):
        cfg['holds'].pop(f'val_data.{k}')
    cfg['overrides']['num_proposals_test'] = 100
    cfg['holds'].pop('num_proposals_test')
    cfg['model']['rpn']['max_num'] = 100
    cfg['data'] = data
    mix = json.load(open(os.path.join(root, 'traffic',
                                      'serve_b8_rcnn.json')))
    mix.update(sizes=SIZES, batch=2, sampled_batches=1)
    return spec.Cell(root=ROOT, name='tiny', chips=1, config=cfg,
                     traffic=copy.deepcopy(mix))


@pytest.fixture
def first_batch(monkeypatch):
    """The window's first batch is the sampled one, and the window takes
    one batch (seconds 0): what is checked does not depend on the CPU's
    speed."""
    monkeypatch.setattr(traffic, 'sample',
                        lambda seed, items, k: list(items)[:k])


def run():
    return serve_rcnn_batches.run(tiny_cell(), SEED, 0.0, False,
                                  time.perf_counter(), CPU)


def test_sound_run_is_correct(first_batch):
    res = run()
    readings = {name: v for name, v, _ in res['checks']}
    assert res['correct'], res['checks']
    assert readings['proposal_gap'] == 0.0 and readings['det_gap'] == 0.0
    for name in ('rpn_gap', 'roi_gap'):
        assert 0 < readings[name] < LIMITS[name]


def test_control_and_planted_faults_are_not_correct(first_batch):
    out = serve_rcnn_batches.control_readings(tiny_cell(), SEED, CPU)
    correct, rows = check.judge(out['control'], LIMITS)
    assert not correct and all(v > lim for _, v, lim in rows), rows
    assert out['neighbour_level']['roi_gap'] > LIMITS['roi_gap']
    assert out['proposals_nms_0.75']['proposal_gap'] > LIMITS['proposal_gap']


def test_roi_from_its_neighbouring_level_is_not_correct(first_batch,
                                                        monkeypatch):
    from kgdet_tpu_torch.models import two_stage
    right = two_stage.map_rois_to_levels

    def neighbour(wh, num_levels, finest_scale=56):
        lvl = right(wh, num_levels, finest_scale)
        return torch.where(lvl < num_levels - 1, lvl + 1, lvl - 1)
    monkeypatch.setattr(two_stage, 'map_rois_to_levels', neighbour)
    res = run()
    readings = {name: v for name, v, _ in res['checks']}
    assert not res['correct'] and readings['roi_gap'] > LIMITS['roi_gap']
