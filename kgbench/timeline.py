"""The traced stretch of a run: spans placed by the benchmark around the
calls into the program's layers, and the device's timeline from
``torch.profiler``.

Spans: a forward pre-hook and a hook on each named submodule open and close
a ``record_function`` range; the stage after the last submodule, up to the
end of the call, is ``tail``. Timed spans also synchronize at each end, so
that a span's host time holds its stage's device work (the pattern of the
repository's ``chip_smoke.py``); the profiled calls take the ranges alone,
since a synchronize would idle the device between stages. Reading the
trace: the device's busy time is the union of its kernels, copies and
memsets inside the stretch; each idle gap is labelled by the innermost
benchmark range and the innermost host operation open at its middle.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch


class StageSpans:
    """Ranges of ``stages`` (name -> submodule) and of the ``tail`` after the
    last of them, per call of the traced function; with ``timed``, also
    their synchronized host milliseconds, in ``ms``."""

    def __init__(self, stages, tail, timed):
        self.stages = stages
        self.tail = tail
        self.timed = timed
        self.ms = defaultdict(list)
        self._open = {}
        self._handles = []

    def sync(self):
        if self.timed:
            torch.cuda.synchronize()

    def _pre(self, name):
        def hook(_module, _args):
            self.sync()
            rf = torch.profiler.record_function(f'kgbench.{name}')
            rf.__enter__()
            self._open[name] = (rf, time.perf_counter())
        return hook

    def _post(self, name):
        def hook(_module, _args, _out):
            self.sync()
            rf, t0 = self._open.pop(name)
            t1 = time.perf_counter()
            rf.__exit__(None, None, None)
            self.ms[name].append((t1 - t0) * 1e3)
            if name == list(self.stages)[-1]:
                tail = torch.profiler.record_function(f'kgbench.{self.tail}')
                tail.__enter__()
                self._open[self.tail] = (tail, t1)
        return hook

    def __enter__(self):
        for name, mod in self.stages.items():
            self._handles += [mod.register_forward_pre_hook(self._pre(name)),
                              mod.register_forward_hook(self._post(name))]
        return self

    def end_call(self):
        """Closes the tail at the end of one traced call."""
        self.sync()
        rf, t0 = self._open.pop(self.tail)
        self.ms[self.tail].append((time.perf_counter() - t0) * 1e3)
        rf.__exit__(None, None, None)

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []


def profiled(fn, calls):
    """Runs ``fn()`` ``calls`` times under torch.profiler, inside a range
    ``kgbench.stretch``, and reads the device's timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('kgbench.stretch'):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    return read_timeline(prof.events(), calls)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_timeline(events, calls):
    """From the profiler's events: the stretch's window and busy seconds,
    device seconds by kernel name, and idle seconds by label."""
    from torch.autograd import DeviceType
    stretch = next(e for e in events if e.name == 'kgbench.stretch'
                   and e.device_type == DeviceType.CPU)
    w0, w1 = stretch.time_range.start, stretch.time_range.end
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.name.startswith('kgbench.')]
    kernels = defaultdict(float)
    spans = []
    for e in device:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t > s:
            kernels[e.name] += (t - s) / 1e6
            spans.append((s, t))
    busy = _union(spans)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU
                   and e.name != 'kgbench.stretch'), key=lambda x: x[0])
    idle = defaultdict(float)
    active, nxt = [], 0                 # a sweep over the gaps' middles
    for s, t in gaps:
        mid = (s + t) / 2
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        stage = next((n[len('kgbench.'):] for _, _, n in reversed(active)
                      if n.startswith('kgbench.')), 'outside')
        op = next((n for _, _, n in reversed(active)
                   if not n.startswith('kgbench.')), 'none')
        idle[f'{stage}: {op}'] += (t - s) / 1e6
    return {
        'calls': calls,
        'window_s': (w1 - w0) / 1e6,
        'busy_s': sum(t - s for s, t in busy) / 1e6,
        'kernels_s': dict(kernels),
        'idle_s': dict(idle),
    }


def breakdown(timeline, top=10):
    """The result line's breakdown: the device operations that took most
    time and the idle time by what the host was doing, in seconds."""
    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]
    return {'device_ops': largest(timeline['kernels_s']),
            'idle_gaps': largest(timeline['idle_s'])}
