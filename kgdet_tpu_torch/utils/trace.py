"""Spans of the program's work, recorded only while a recording is open.

``span(name)`` marks a stretch of host work (a predict call, its forward,
a train step's backward, the wait for the loader's next batch, ...). With
no recording open it returns one shared object that does nothing: no
clock is read, nothing is allocated and no profiler range is entered, so
the spans cost a function call on the main path. Inside ``recording()``
each span appends a ``SpanRecord`` when it closes: its name, its start
and end on ``time.perf_counter_ns()``, the id of the enclosing span on the
same thread (``parent``), the id of the outermost one (``root``, shared
by every span of one top-level call) and the thread's native id; a span
left by an exception records nothing, since its work did not end. While
torch's profiler is also running, the span opens
``torch.profiler.record_function('kgdet.<name>')`` as well, so that it
lies on the device trace's host timeline. No span synchronizes the
device: a span's host time ends when its host work does, which may be
before its kernels finish.

``Recording.anchor_ns`` is ``time.time_ns() - time.perf_counter_ns()``
when the recording opened: ``start_ns + anchor_ns`` is on the wall clock,
which is the clock of torch.profiler's host events (the profile's
``trace_start_ns`` plus an event's ``time_range`` in microseconds).

The program's spans: ``request`` (``api.Detector.__call__``) with
``preprocess``, ``predict`` and ``fetch``; ``predict``
(``api.make_predict_fn``) with ``forward`` and ``decode``; ``forward``
with ``backbone``, ``neck`` and ``head`` (``KGDetDetector.forward``), or
in a two-stage detector (``models/two_stage.py``, every ``TwoStageBase``)
with ``backbone`` and ``neck`` (``features``), ``rpn`` (the RPN head),
``proposals`` (their decode and NMS), ``roi_extract`` (each
``extract_roi_feats``, the RoI gathers) and ``roi_head`` (the box head,
each stage's in Cascade R-CNN), and in HTC ``semantic`` (the semantic
branch) and ``mask_head`` (the three mask heads; their RoI gather is a
``roi_extract``); ``step`` (``parallel/train.py::make_train_step``) with
``forward``, ``loss``, ``backward``, in a process group ``allreduce``
(``parallel/dist.py::all_reduce_grads``), and ``optimizer``;
``data.fetch`` and ``data.stage`` (``runner.Runner._device_prefetch``,
``_to_device``).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    thread: int


class Recording:
    """The spans closed since the recording opened, in closing order."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self.anchor_ns = time.time_ns() - time.perf_counter_ns()
        self._ids = itertools.count()
        self._open = threading.local()      # each thread's open spans

    def _stack(self):
        stack = getattr(self._open, 'stack', None)
        if stack is None:
            stack = self._open.stack = []
        return stack


_active: Optional[Recording] = None
_opening = threading.Lock()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ('rec', 'name', 'id', 'parent', 'root', 'range', 'start')

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec._stack()
        outer = stack[-1] if stack else None
        self.id = next(self.rec._ids)
        self.parent = None if outer is None else outer.id
        self.root = self.id if outer is None else outer.root
        stack.append(self)
        self.range = None
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(f'kgdet.{self.name}')
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        self.rec._stack().pop()
        if exc_type is None:
            self.rec.records.append(SpanRecord(
                self.name, self.start, end, self.id, self.parent, self.root,
                threading.get_native_id()))
        return False


def span(name: str):
    """A context manager around one stretch of the program's work: a
    recorded span inside ``recording()``, else a shared no-op."""
    rec = _active
    return _OFF if rec is None else _Span(rec, name)


@contextlib.contextmanager
def recording():
    """Records every span closed while it is open, on every thread, and
    yields the ``Recording``. One recording at a time: opening a second
    raises."""
    global _active
    with _opening:
        if _active is not None:
            raise RuntimeError('a trace recording is already open')
        rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None
