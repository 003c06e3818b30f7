"""The four-card training cell on the CPU: it resolves by its names alone;
the sharded sampling of its reference; the all-reduce reading on
synthetic profiler events and its reader; and the driver's processes, as
4 gloo ranks of the cascade at a small size, correct against the
reference, with the control and the fault of one process's images alone
not correct."""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from kgbench import check, spec
from kgbench.drivers import train_ddp
from kgbench.reference import train_batch, train_shards
from kgbench.tests import tiny

CELL = 'kgdet_cascade_r50.train_ddp4'
CPU = torch.device('cpu')
SEED = 2 ** 31 + 11


def test_the_cell_resolves_by_its_names():
    cell = spec.load(tiny.ROOT, CELL)
    assert cell.chips == 4 and cell.traffic['driver'] == 'train_ddp'
    assert {m['name'] for m in cell.end_to_end} == {
        'train_img_s', 'peak_mem_gib', 'setup_s'}
    assert [m['name'] for m in cell.per_layer] == [
        'idle_pct.train', 'allreduce_ms.ddp4']
    assert cell.config['train']['batch_size'] % cell.chips == 0


def test_each_process_takes_its_stride_of_the_epochs_batches():
    wide = np.random.default_rng(0).uniform(size=40) > 0.4
    picks = train_shards.shard_picks(wide, 4, 2, 3, 0)
    batches = train_batch.epoch_batches(wide, 2, 0, 0)
    assert [len(step) for step in picks] == [4, 4, 4]
    for k, step in enumerate(picks):
        for r, idx in enumerate(step):
            assert np.array_equal(idx, batches[4 * k + r])
            assert len(set(wide[idx])) == 1          # one canvas a batch


def _event(name, kind, start, end, id_=0):
    return SimpleNamespace(name=name, device_type=kind, id=id_,
                           time_range=SimpleNamespace(start=start, end=end))


def test_allreduce_reading_counts_nccl_kernels_launched_inside_the_span():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _event('kgdet.allreduce', cpu, 100, 200),
        _event('cudaLaunchKernel', cpu, 120, 125, 1),     # inside
        _event('ncclDevKernel_AllReduce_Sum_f32', cuda, 300, 2300, 1),
        _event('cudaLaunchKernel', cpu, 50, 55, 2),       # before: a loss sum
        _event('ncclDevKernel_AllReduce_Sum_f32', cuda, 60, 160, 2),
        _event('cudaLaunchKernel', cpu, 130, 135, 3),     # not NCCL
        _event('elementwise_kernel', cuda, 140, 900, 3),
        _event('ncclDevKernel_AllReduce_Sum_f32', cuda, 10, 40, 9),
    ]
    records = [SimpleNamespace(name=n) for n in ('step', 'allreduce',
                                                 'optimizer')]
    got = train_ddp.allreduce_reading(records, events)
    assert got == {'calls': 1, 'device_s': 2e-3}
    read = spec.reader('allreduce_ms.ddp4')
    assert read({'allreduce': got}) == pytest.approx(2.0)
    for obs in ({}, {'allreduce': None},
                {'allreduce': dict(got, calls=0, device_s=0.0)}):
        assert read(obs) is None


def tiny_cell():
    """The cascade on 128x192 canvases, the batch of 8 over 4 processes,
    a small set of small images."""
    cfg = tiny.config()
    cfg['overrides']['train_data.batch_size'] = 8
    cfg['train']['batch_size'] = 8
    mix = json.load(open(f'{tiny.ROOT}/kgbench/traffic/train_ddp4.json'))
    mix.update(sizes=tiny.SIZES, files=16, records=80,
               warmup_steps_per_canvas=1)
    return spec.Cell(root=tiny.ROOT, name='tiny', chips=4, config=cfg,
                     traffic=mix)


def test_four_gloo_processes_are_correct_against_the_reference():
    cell = tiny_cell()
    res = train_ddp.run(cell, SEED, 0.0, False, time.perf_counter(), CPU)
    readings = {name: v for name, v, _ in res['checks']}
    assert res['correct'], res['checks']
    assert readings['batch_gap'] == 0.0
    assert res['attempted'] % 8 == 0 and res['e2e']['train_img_s'] > 0
    waits = res['obs']['data_wait_s']       # process 0's, a window's step
    assert len(waits) == res['attempted'] // 8 and min(waits) >= 0
    assert spec.reader('data_wait_ms.train')(res['obs']) >= 0
    out = train_ddp.control_readings(cell, SEED, CPU)
    limits = cell.config['train_limits']
    assert not check.judge(out['control'], limits)[0]
    assert out['control']['batch_gap'] > limits['batch_gap']
    assert out['one_process']['update_gap'] > limits['update_gap']
