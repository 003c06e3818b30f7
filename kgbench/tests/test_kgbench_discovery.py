"""The harness finds a cell, a configuration, a traffic mix and a
per-layer metric by name from files alone: a copy of the benchmark gains
each by new files and entries, and no file of the harness changes."""
import json
import os
import shutil

import pytest

from kgbench import spec
from kgbench.tests.tiny import ROOT


@pytest.fixture
def copy(tmp_path):
    shutil.copytree(os.path.join(ROOT, 'kgbench'), tmp_path / 'kgbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    return tmp_path


def test_every_cell_of_benchmark_json_resolves():
    bench = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    for w in bench['workloads']:
        cell = spec.load(ROOT, w['name'])
        assert cell.end_to_end and cell.per_layer
        assert {'setup_s'} <= {m['name'] for m in cell.end_to_end}
        cell.module('drivers', cell.traffic['driver'])
        cell.module('reference', cell.config['reference'])
        for m in cell.per_layer:
            assert callable(spec.reader(m['name']))


def test_new_cell_mix_config_and_metric_are_files_and_entries(copy,
                                                               monkeypatch):
    before = {p: open(p, 'rb').read() for p in map(str, copy.rglob('*.py'))}
    kg = copy / 'kgbench'
    mix = json.load(open(kg / 'traffic' / 'serve_b8.json'))
    mix['batch'] = 4
    json.dump(mix, open(kg / 'traffic' / 'serve_b4.json', 'w'))
    conf = json.load(open(kg / 'configs' / 'kgdet_cascade_r50.json'))
    conf['name'] = 'kgdet_cascade_r50_b'
    json.dump(conf, open(kg / 'configs' / 'kgdet_cascade_r50_b.json', 'w'))
    (kg / 'metrics' / 'batches.serve.py').write_text(
        'def read(obs):\n    return obs["images"] / obs["batch"]\n')
    bench = json.load(open(copy / 'BENCHMARK.json'))
    bench['configs'].append(dict(bench['configs'][0],
                                 name='kgdet_cascade_r50_b',
                                 file='kgbench/configs/'
                                      'kgdet_cascade_r50_b.json'))
    bench['workloads'].append({
        'name': 'kgdet_cascade_r50_b.serve_b4',
        'config': 'kgdet_cascade_r50_b', 'traffic': 'serve_b4', 'chips': 1,
        'why': 'a cell added by files alone'})
    for m in bench['end_to_end']:
        if m['name'] == 'serve_img_s':
            m['workloads'].append('kgdet_cascade_r50_b.serve_b4')
    bench['per_layer'].append({
        'name': 'batches.serve', 'unit': 'batches', 'better': 'higher',
        'source': 'host_clock', 'layer': 'API', 'moves': 'serve_img_s',
        'workloads': ['kgdet_cascade_r50_b.serve_b4']})
    json.dump(bench, open(copy / 'BENCHMARK.json', 'w'))

    monkeypatch.setattr(spec, 'HERE', str(kg))
    cell = spec.load(str(copy), 'kgdet_cascade_r50_b.serve_b4')
    assert cell.traffic['batch'] == 4
    assert cell.config['name'] == 'kgdet_cascade_r50_b'
    assert 'serve_img_s' in {m['name'] for m in cell.end_to_end}
    assert 'serve_p95_ms' not in {m['name'] for m in cell.end_to_end}
    assert [m['name'] for m in cell.per_layer] == ['batches.serve']
    assert spec.reader('batches.serve')({'images': 40, 'batch': 4}) == 10
    after = {p: open(p, 'rb').read() for p in before}
    assert after == before
