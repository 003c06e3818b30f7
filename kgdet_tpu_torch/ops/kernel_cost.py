"""The arithmetic and the bytes of the port's kernels, for FLOP counts.

``torch.utils.flop_counter.FlopCounterMode`` counts the library's ops, but
the port's kernels run through ``ctypes`` and are invisible to it, while
their plain versions on the CPU are gathers and einsums that it would count
differently. Each kernel's wrapper is therefore decorated with
``counted(name, cost)``, beside the wrapper: while a ``tally()`` is open, a
call adds ``cost(*args)`` (operations, bytes) under the kernel's name and
runs with the dispatch modes off, so nothing inside it, kernel or plain
version, reaches a FlopCounterMode. The count is then the same on the CPU
and on the card. A wrapper called from inside another counted wrapper (a
prepared entry under its unprepared one) adds nothing. Under
torch.profiler a call of a plain version is also a range named after its
kernel (tools/profile.py); a kernel names itself.

The formulas are the bound arithmetic of PERF.md section 6: the operations
of the function (a bilinear sample is 7 operations a value, its backward
26, a contraction 2 a multiply-add), and the bytes a kernel must move, each
input read once and each output written once.
"""
from __future__ import annotations

import contextlib
import functools
from collections import defaultdict

import torch
from torch.utils._python_dispatch import _disable_current_modes

from kgdet_tpu_torch.ops import runs_kernel

_TALLIES = []
_DEPTH = [0]


class Tally:
    """Per kernel name: launches, operations and bytes, summed."""

    def __init__(self):
        self.kernels = defaultdict(lambda: {'calls': 0, 'flops': 0,
                                            'bytes': 0})

    @property
    def flops(self):
        return sum(k['flops'] for k in self.kernels.values())

    @property
    def bytes(self):
        return sum(k['bytes'] for k in self.kernels.values())


@contextlib.contextmanager
def tally():
    """Count the port's kernel calls in the block: yields a ``Tally``."""
    t = Tally()
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.remove(t)


def counted(name, cost):
    """Decorate a kernel wrapper with its cost(*args, **kwargs) -> (ops,
    bytes), added to every open tally a call. Under torch.profiler a call
    that runs the plain version (``runs_kernel`` false) is also a
    ``record_function`` range named ``name``; a kernel's own name is in the
    trace."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _DEPTH[0] or not (_TALLIES or
                                 torch._C._autograd._profiler_enabled()):
                return fn(*args, **kwargs)
            if _TALLIES:
                ops, n_bytes = cost(*args, **kwargs)
                for t in _TALLIES:
                    k = t.kernels[name]
                    k['calls'] += 1
                    k['flops'] += int(ops)
                    k['bytes'] += int(n_bytes)
            # a range only around a plain version: on the card the kernel
            # names itself, and a range would add an annotation to the
            # device's timeline beside the one kernel a call
            plain = not runs_kernel(args[0])
            _DEPTH[0] += 1
            try:
                with (torch.profiler.record_function(name) if plain
                      else contextlib.nullcontext()), \
                        _disable_current_modes():
                    return fn(*args, **kwargs)
            finally:
                _DEPTH[0] -= 1
        return wrapper
    return wrap


def nbytes(*ts):
    """Bytes of the tensors given (None skipped)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------- the formulas
def sample_ops(n_values):
    """A bilinear sample: 4 corner weights applied and summed, 7 operations
    a value."""
    return 7 * n_values


def bottleneck_cost(x, w1, b1=None, w2=None, b2=None, w3=None, b3=None,
                    wd=None, bd=None):
    """A frozen bottleneck (K5, K8): its convs, 2 a multiply-add (bias and
    ReLU not counted); the input, the weights and the output once. Takes
    the unprepared arguments or (x, prepared block)."""
    ws = (w1, b1, w2, b2, w3, b3, wd, bd) if b1 is not None else tuple(w1)
    B, H, W, cin = x.shape
    width, cout = ws[0].shape[-1], ws[4].shape[-1]
    macs = cin * width + 9 * width * width + width * cout \
        + (cin * cout if ws[6] is not None else 0)
    return (2 * B * H * W * macs,
            nbytes(x, *ws) + B * H * W * cout * x.element_size())
