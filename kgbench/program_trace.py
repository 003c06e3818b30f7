"""The program's own spans (``kgdet_tpu_torch/utils/trace.py``), read for
the benchmark: two stretches after a cell's traced stretch, and what each
span costs on the host and on the device.

``stretches(call, calls)`` runs ``call()`` ``ALONE_CALLS`` times inside a
recording with no profiler (host milliseconds a span, as the program runs
when nothing but its own clock reads are added), then ``calls`` times
inside a recording under torch.profiler (launches and idle a span). A
program without the tracer (no ``kgdet_tpu_torch.utils.trace``) gives
None, and so does every reading.

``summarize(records, events)``: for each span name its calls and host ms
a call (mean, median) from the records; with the profiler's events also

- ``launches``: the device operations (kernels, copies, memsets) whose
  launch call, the runtime event with the operation's correlation id,
  lies inside one of the span's ``kgdet.<name>`` ranges on the launching
  thread, the innermost range winning;
- ``idle_s``: the device-idle seconds inside the stretch whose gap's
  middle falls while this span, or a span inside it, is open on the
  stretch's thread (the middle rule of ``timeline.read_timeline``);

and, for the stretch, the device operations and idle seconds that no span
claims, and the operations whose launch the trace does not link.
``kgdet.*`` and ``kgbench.*`` ranges the profiler copies onto the device's
timeline are annotations, not work, and count neither as operations nor
as busy time.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

ALONE_CALLS = 20
PREFIX = 'kgdet.'


def _open_at(ranges, t):
    """The ranges of one thread (start, end, name), sorted by start, that
    are open at ``t``, outermost first."""
    i = bisect.bisect_right(ranges, (t, float('inf'), ''))
    return [r for r in ranges[:i] if r[1] >= t]


def _host(records):
    ms = defaultdict(list)
    for r in records:
        ms[r.name].append((r.end_ns - r.start_ns) / 1e6)
    return {name: {'calls': len(v), 'mean_ms': sum(v) / len(v),
                   'median_ms': statistics.median(v)}
            for name, v in ms.items()}


def summarize(records, events=None):
    """Per span name (see the module's docstring) and, with ``events``, the
    stretch's ``device`` totals."""
    spans = _host(records)
    if events is None:
        return {'spans': spans}
    from torch.autograd import DeviceType
    stretch = next(e for e in events if e.name == 'kgbench.stretch'
                   and e.device_type == DeviceType.CPU)
    w0, w1 = stretch.time_range.start, stretch.time_range.end
    ranges = defaultdict(list)          # thread -> its program ranges
    runtime = {}                        # correlation id -> launch call
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith(PREFIX):
            ranges[e.thread].append((e.time_range.start, e.time_range.end,
                                     e.name[len(PREFIX):]))
        elif e.name.startswith('cu'):   # cudaLaunchKernel, cuLaunchKernel,
            runtime[e.id] = e           # cudaMemcpyAsync, cudaMemsetAsync
    for r in ranges.values():
        r.sort()
    main = ranges.get(stretch.thread, [])

    launches = defaultdict(int)
    ops = unclaimed = unlinked = 0
    busy = []
    for e in events:
        if e.device_type != DeviceType.CUDA or \
                e.name.startswith((PREFIX, 'kgbench.')):
            continue
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        busy.append((s, t))
        ops += 1
        call = runtime.get(e.id)
        if call is None:
            unlinked += 1
            unclaimed += 1
            continue
        open_ = _open_at(ranges.get(call.thread, main),
                         call.time_range.start)
        if open_:
            launches[open_[-1][2]] += 1
        else:
            unclaimed += 1

    idle = defaultdict(float)
    idle_total = unclaimed_idle = 0.0
    prev = w0
    for s, t in sorted(busy) + [(w1, w1)]:
        if s > prev:
            gap = (s - prev) / 1e6
            idle_total += gap
            names = {n for _, _, n in _open_at(main, (prev + s) / 2)}
            for n in names:
                idle[n] += gap
            if not names:
                unclaimed_idle += gap
        prev = max(prev, t)
    for name, v in spans.items():
        v['launches'] = launches.get(name, 0)
        v['idle_s'] = idle.get(name, 0.0)
    return {'spans': spans, 'device': {
        'window_s': (w1 - w0) / 1e6, 'idle_s': idle_total,
        'unclaimed_idle_s': unclaimed_idle, 'ops': ops,
        'unclaimed_ops': unclaimed, 'unlinked_ops': unlinked}}


def stretches(call, calls):
    """{'alone': summary, 'profiled': summary} of ``ALONE_CALLS`` calls in
    a recording and ``calls`` calls in a recording under the profiler, in
    a range ``kgbench.stretch``; None without the program's tracer."""
    try:
        from kgdet_tpu_torch.utils import trace
    except ImportError:
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with trace.recording() as rec:
        for _ in range(ALONE_CALLS):
            call()
    torch.cuda.synchronize()
    alone = summarize(rec.records)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.recording() as rec, record_function('kgbench.stretch'):
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
    return {'alone': alone, 'profiled': summarize(rec.records,
                                                  prof.events())}


def _span(obs, stretch, name):
    pt = obs.get('program_trace')
    return None if pt is None else pt[stretch]['spans'].get(name)


def _host_ms(name, stat):
    def read(obs):
        s = _span(obs, 'alone', name)
        return None if s is None else s[stat]
    return read


def _launches(name):
    def read(obs):
        s = _span(obs, 'profiled', name)
        return None if s is None else s['launches'] / s['calls']
    return read


def _decode_idle_pct(obs):
    s = _span(obs, 'profiled', 'decode')
    if s is None:
        return None
    idle = obs['program_trace']['profiled']['device']['idle_s']
    return 100.0 * s['idle_s'] / idle if idle > 0 else None


def _loader_wait_ms(obs):
    fetch, step = (_span(obs, 'alone', n) for n in ('data.fetch', 'step'))
    if fetch is None or step is None:
        return None
    return fetch['mean_ms'] * fetch['calls'] / step['calls']


# per-layer readings of the spans, by metric name: each takes a run's
# observations, whose 'program_trace' holds ``stretches``' result
READINGS = {
    'decode_launches.serve': _launches('decode'),
    'decode_idle_pct.serve': _decode_idle_pct,
    'step_host_ms.train': _host_ms('step', 'mean_ms'),
    'loss_ms.train': _host_ms('loss', 'mean_ms'),
    'optimizer_launches.train': _launches('optimizer'),
    'loader_wait_ms.train': _loader_wait_ms,
    'preprocess_ms.online': _host_ms('preprocess', 'median_ms'),
}
