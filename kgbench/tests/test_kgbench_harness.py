"""The harness's own mechanics on the CPU: the open loop times each
request from its due time, the traced stretch's timeline is read into busy
and idle time, and the result line has the contract's keys and no more."""
import time
from types import SimpleNamespace

import pytest

from kgbench import run, timeline
from kgbench.drivers import serve_online


def test_open_loop_times_each_request_from_its_due_time():
    # three requests due at once, then one after a pause; each takes 50 ms
    due = [0.0, 0.0, 0.0, 0.5]
    start = time.perf_counter() + 0.05

    def serve(j):
        time.sleep(0.05)
        return j
    t = serve_online.open_loop(due, serve, start, keep={1, 3})
    assert t['failed'] == 0 and t['outputs'] == {1: 1, 3: 3}
    lat, wait = t['latency_s'], t['wait_s']
    # the second waits for the first, the third for both
    assert wait[0] < 0.02 and 0.04 < wait[1] < 0.08 and 0.09 < wait[2] < 0.14
    assert lat[2] == pytest.approx(wait[2] + t['service_s'][2], abs=1e-3)
    assert 0.14 < lat[2] < 0.2
    # the fourth found the server idle: only the generator's lateness
    assert wait[3] < 0.02 and len(t['late_s']) == 2


def test_open_loop_counts_a_failed_request_as_missing():
    def serve(j):
        if j == 1:
            raise RuntimeError('broken')
        return j
    t = serve_online.open_loop([0.0, 0.0, 0.0], serve, time.perf_counter())
    assert t['failed'] == 1 and t['latency_s'][1] == float('inf')


def _ev(name, kind, start, end):
    from torch.autograd import DeviceType
    dev = DeviceType.CPU if kind == 'cpu' else DeviceType.CUDA
    return SimpleNamespace(name=name, device_type=dev,
                           time_range=SimpleNamespace(start=start, end=end))


def test_timeline_busy_idle_and_labels():
    events = [
        _ev('kgbench.stretch', 'cpu', 0, 1000),
        _ev('kgbench.decode', 'cpu', 100, 900),
        _ev('aten::argmax', 'cpu', 150, 400),
        _ev('k_a', 'cuda', 0, 100),
        _ev('k_b', 'cuda', 50, 150),        # overlaps k_a
        _ev('k_a', 'cuda', 400, 600),
        _ev('kgbench.decode', 'cuda', 100, 900),   # a range, not work
    ]
    tl = timeline.read_timeline(events, calls=2)
    assert tl['window_s'] == pytest.approx(1000e-6)
    assert tl['busy_s'] == pytest.approx(350e-6)
    assert tl['kernels_s'] == pytest.approx({'k_a': 300e-6, 'k_b': 100e-6})
    assert tl['idle_s'] == pytest.approx({'decode: aten::argmax': 250e-6,
                                          'decode: none': 400e-6})
    b = timeline.breakdown(tl)
    assert b['device_ops'][0] == ['k_a', pytest.approx(300e-6)]
    assert len(b['idle_gaps']) == 2


CONTRACT = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.mark.parametrize('trace', [False, True])
def test_result_line_has_the_contract_keys(trace, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'get_device_name',
                        lambda *a: 'NVIDIA H100 80GB HBM3')
    cell = SimpleNamespace(
        chips=1,
        end_to_end=[{'name': 'serve_img_s', 'unit': 'img/s'},
                    {'name': 'setup_s', 'unit': 's'}],
        per_layer=[{'name': 'idle_pct.serve', 'unit': '%'},
                   {'name': 'mfu.serve', 'unit': '%'}])
    tl = {'calls': 1, 'window_s': 2.0, 'busy_s': 0.5,
          'kernels_s': {'k': 0.5}, 'idle_s': {'decode: x': 1.5}}
    res = {'correct': True, 'attempted': 80, 'failed': 0,
           'e2e': {'serve_img_s': 99.5, 'setup_s': 9.1},
           'obs': {'timeline': tl}, 'peak_bytes': 123,
           'checks': [('det_gap', 0.0, 0.001), ('head_gap', 0.04, 0.12)]}
    line = run.result_line(cell, res, trace)
    assert list(line) == CONTRACT + (['breakdown'] if trace else []) + \
        ['checks']
    assert line['checks'] == {'det_gap': {'value': 0.0, 'limit': 0.001},
                              'head_gap': {'value': 0.04, 'limit': 0.12}}
    dev = line['device']
    assert dev['platform'] == 'gpu' and dev['count'] == 1
    assert dev['kind'] == 'NVIDIA H100 80GB HBM3'
    assert dev['memory_peak_bytes'] == 123
    if trace:
        # mfu.serve finds no operation count here: left out, never 0
        assert line['metrics'] == {'idle_pct.serve': {'value': 75.0,
                                                      'unit': '%'}}
        assert dev['busy_s'] == 0.5 and dev['window_s'] == 2.0
        assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
    else:
        assert line['metrics'] == {
            'serve_img_s': {'value': 99.5, 'unit': 'img/s'},
            'setup_s': {'value': 9.1, 'unit': 's'}}
        assert set(dev) == {'platform', 'kind', 'count',
                            'memory_peak_bytes'}


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    rc = run.main(['--workload', 'kgdet_cascade_r50.serve_b8', '--seed',
                   '1', '--seconds', '1', '--trace', '0'])
    out = capsys.readouterr()
    assert rc != 0 and out.out == '' and 'CUDA' in out.err
