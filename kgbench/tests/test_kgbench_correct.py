"""``correct`` on the CPU at a small size: a sound run of each serving
driver is correct; the control (the reference in float8 for the forward,
bfloat16 for the decode, in the program's place) and each fault a serving
cell can have, planted in the timed path, make it false. On the card, the
control's readings at the cells' sizes are in PERF.md (kgbench/calibrate.py).
"""
import time

import pytest
import torch

from kgbench import check
from kgbench.drivers import serve_batches, serve_online
from kgbench.tests import tiny

CPU = torch.device('cpu')
SEED = 2 ** 31 + 99
DRIVERS = {'offline': (serve_batches, tiny.offline_mix),
           'online': (serve_online, tiny.online_mix)}


def run(kind):
    driver, mix = DRIVERS[kind]
    return driver.run(tiny.cell(mix()), SEED, 1.5, False, time.perf_counter(),
                      CPU)


@pytest.mark.parametrize('kind', sorted(DRIVERS))
def test_sound_run_is_correct(kind):
    res = run(kind)
    readings = {name: v for name, v, _ in res['checks']}
    assert res['correct'], res['checks']
    assert readings['det_gap'] == 0.0
    assert 0 < readings['head_gap'] < tiny.config()['limits']['head_gap']


@pytest.mark.parametrize('kind', sorted(DRIVERS))
def test_control_is_not_correct(kind):
    driver, mix = DRIVERS[kind]
    cell = tiny.cell(mix())
    readings = driver.control_readings(cell, SEED, CPU)['control']
    correct, rows = check.judge(readings, cell.config['limits'])
    assert not correct
    assert all(v > lim for _, v, lim in rows), rows


def _shift_boxes(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        out['det_bboxes'] = out['det_bboxes'] + 2.0
        return out
    return broken


def _half_batch(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs)
        valid = out['valid'].clone()
        valid[valid.shape[0] // 2:] = False
        out['valid'] = valid
        return out
    return broken


def _logits_altered(fn):
    def broken(self, *args, **kwargs):
        cls, kpt, rep = fn(self, *args, **kwargs)
        return cls * 1.5, kpt, rep
    return broken


# a request of the online mix is one image: it has no half to leave out
FAULTS = [(k, f) for k in sorted(DRIVERS)
          for f in ('answer_altered', 'half_batch', 'head_altered')
          if (k, f) != ('online', 'half_batch')]


@pytest.mark.parametrize('kind,fault', FAULTS)
def test_fault_is_not_correct(kind, fault, monkeypatch):
    from kgdet_tpu_torch.core import postprocess
    from kgdet_tpu_torch.models.kgdet_head import KpRepBlock
    if fault == 'head_altered':
        monkeypatch.setattr(KpRepBlock, 'forward',
                            _logits_altered(KpRepBlock.forward))
    else:
        wrap = _shift_boxes if fault == 'answer_altered' else _half_batch
        monkeypatch.setattr(postprocess, 'nms_detections',
                            wrap(postprocess.nms_detections))
    assert not run(kind)['correct']


def train_run():
    from kgbench.drivers import train_loop
    return train_loop.run(tiny.cell(tiny.train_mix()), SEED, 1.0, False,
                          time.perf_counter(), CPU)


def test_sound_training_is_correct():
    res = train_run()
    readings = {name: v for name, v, _ in res['checks']}
    assert res['correct'], res['checks']
    assert readings['batch_gap'] == 0.0
    assert 0 < readings['loss_gap'] < 1e-2


def test_training_control_and_half_batch_are_not_correct():
    from kgbench.drivers import train_loop
    cell = tiny.cell(tiny.train_mix())
    out = train_loop.control_readings(cell, SEED, CPU)
    for side in ('control', 'half_batch'):
        correct, rows = check.judge(dict(out[side], **(
            {} if 'batch_gap' in out[side] else {'batch_gap': 0.0})),
            cell.config['train_limits'])
        assert not correct, (side, rows)


@pytest.mark.parametrize('fault', ['state_unchanged', 'half_batch'])
def test_training_fault_is_not_correct(fault, monkeypatch):
    from kgdet_tpu_torch.parallel import train
    if fault == 'state_unchanged':
        def step(self):
            self.step_count += 1
            return torch.zeros(())
        monkeypatch.setattr(train.SGDOptimizer, 'step', step)
    else:
        compute = train.compute_loss

        def half(outs, grids, valids, batch, cfg, canvas_hw=None):
            B = len(batch['image'])
            keep = slice(0, B // 2)
            outs = [{k: v[:, keep] for k, v in lvl.items()} for lvl in outs]
            return compute(outs, grids, [v[keep] for v in valids],
                           {k: v[keep] for k, v in batch.items()}, cfg,
                           canvas_hw)
        monkeypatch.setattr(train, 'compute_loss', half)
    assert not train_run()['correct']
