"""kgbench/program_trace.py on synthetic records and profiler events: a
launch inside nested spans goes to the innermost, an idle gap to every
span open at its middle, and what no span claims is counted; the
readings give None where the program has no spans."""
import sys
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from kgbench import program_trace
from kgdet_tpu_torch.utils.trace import SpanRecord

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, thread=1):
    return NS(name=name, device_type=device, id=id, thread=thread,
              time_range=NS(start=start, end=end))


def events():
    """A stretch of 0..1000 us: predict 0..600 holding decode 300..600 on
    thread 1; kernels launched inside decode, inside predict alone,
    outside both, and one with no launch call in the trace."""
    return [
        ev('kgbench.stretch', 0, 1000),
        ev('kgdet.predict', 0, 600), ev('kgdet.decode', 300, 600),
        ev('cudaLaunchKernel', 100, 105, id=11),        # predict
        ev('cudaLaunchKernel', 350, 355, id=12),        # decode
        ev('cudaLaunchKernel', 360, 365, id=13),        # decode
        ev('cudaLaunchKernel', 700, 705, id=14),        # no span
        ev('aten::add', 340, 370, id=12),               # not a launch call
        ev('k_a', 110, 200, CUDA, id=11), ev('k_b', 400, 450, CUDA, id=12),
        ev('k_c', 450, 480, CUDA, id=13), ev('k_d', 750, 800, CUDA, id=14),
        ev('k_e', 900, 950, CUDA, id=99),               # unlinked
        ev('kgdet.decode', 300, 600, CUDA),             # an annotation
    ]


def test_a_launch_goes_to_the_innermost_span_and_the_rest_is_unclaimed():
    recs = [SpanRecord('decode', 300, 600, 1, 0, 0, 5),
            SpanRecord('predict', 0, 600, 0, None, 0, 5)]
    out = program_trace.summarize(recs, events())
    assert out['spans']['decode']['launches'] == 2
    assert out['spans']['predict']['launches'] == 1
    d = out['device']
    assert (d['ops'], d['unclaimed_ops'], d['unlinked_ops']) == (5, 2, 1)


def test_an_idle_gap_goes_to_every_span_open_at_its_middle():
    recs = [SpanRecord('decode', 300, 600, 1, 0, 0, 5),
            SpanRecord('predict', 0, 600, 0, None, 0, 5)]
    out = program_trace.summarize(recs, events())
    # busy 110..200, 400..480, 750..800, 900..950 (the annotation is not
    # work); gaps 0..110 and 200..400 (middles in predict, then decode),
    # 480..750 (middle 615: none), 800..900 and 950..1000 (none)
    s, d = out['spans'], out['device']
    assert s['predict']['idle_s'] == pytest.approx(310e-6)
    assert s['decode']['idle_s'] == pytest.approx(200e-6)
    assert d['idle_s'] == pytest.approx(730e-6)
    assert d['unclaimed_idle_s'] == pytest.approx(420e-6)
    assert d['window_s'] == pytest.approx(1e-3)


def test_host_ms_come_from_the_records():
    recs = [SpanRecord('step', 0, 4_000_000, 0, None, 0, 5),
            SpanRecord('step', 0, 2_000_000, 1, None, 1, 5),
            SpanRecord('step', 0, 9_000_000, 2, None, 2, 5)]
    s = program_trace.summarize(recs)
    assert s == {'spans': {'step': {'calls': 3, 'mean_ms': 5.0,
                                    'median_ms': 4.0}}}


def test_readings_of_a_summary():
    def span(calls, mean_ms=1.0, median_ms=1.0, launches=0, idle_s=0.0):
        return dict(calls=calls, mean_ms=mean_ms, median_ms=median_ms,
                    launches=launches, idle_s=idle_s)
    obs = {'program_trace': {
        'alone': {'spans': {'step': span(20, 110.0), 'loss': span(20, 9.0),
                            'data.fetch': span(20, 2.5),
                            'preprocess': span(20, 40.0, 45.0)}},
        'profiled': {'spans': {'decode': span(4, launches=14000,
                                              idle_s=0.3),
                               'optimizer': span(4, launches=4000)},
                     'device': {'idle_s': 0.4}}}}
    r = {k: f(obs) for k, f in program_trace.READINGS.items()}
    assert r == {'decode_launches.serve': 3500.0,
                 'decode_idle_pct.serve': pytest.approx(75.0),
                 'step_host_ms.train': 110.0, 'loss_ms.train': 9.0,
                 'optimizer_launches.train': 1000.0,
                 'loader_wait_ms.train': 2.5, 'preprocess_ms.online': 45.0}


@pytest.mark.parametrize('metric', sorted(program_trace.READINGS))
def test_each_reading_is_none_without_program_records(metric):
    read = program_trace.READINGS[metric]
    assert read({'images': 8, 'seconds': 1.0}) is None
    assert read({'program_trace': None}) is None
    empty = {'spans': {}, 'device': {'idle_s': 1.0}}
    assert read({'program_trace': {'alone': empty, 'profiled': empty}}) \
        is None


def test_no_stretches_without_the_programs_tracer(monkeypatch):
    import kgdet_tpu_torch.utils
    monkeypatch.setitem(sys.modules, 'kgdet_tpu_torch.utils.trace', None)
    monkeypatch.delattr(kgdet_tpu_torch.utils, 'trace')
    calls = []
    assert program_trace.stretches(lambda: calls.append(1), 4) is None
    assert calls == []
