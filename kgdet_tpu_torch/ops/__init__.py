"""Tensor ops of the port: plain PyTorch functions and the kernel wrappers.

Every kernel wrapper (K1 to K6, K8 to K10 in ops/deform_kernels.py,
ops/stem_kernels.py, ops/resblock.py, ops/nms.py and ops/bn_epilogue.py)
decides by one rule whether a call launches its CUDA kernel or runs its
plain PyTorch version, the reference a kernel is checked against:
``runs_kernel(t)``. A call runs its kernel if and only if its tensor is off
the CPU and no ``plain_kernels()`` block is open. The comparison model is
the same model run inside ``with plain_kernels(): ...``; no layer above
ops/ knows the choice.

An autograd Function decides at its forward and keeps the decision on
``ctx`` for its backward (ops/deform_kernels.py): autograd runs a CUDA
backward on its own device threads, where a block opened in the caller's
thread is not seen, and a backward may run after the block has closed.
"""
from __future__ import annotations

import contextlib
import contextvars

_PLAIN = contextvars.ContextVar('kgdet_plain_kernels', default=False)


@contextlib.contextmanager
def plain_kernels(plain: bool = True):
    """Inside the block every kernel wrapper runs its plain version,
    whatever the device; ``plain`` False restores the kernels inside an
    enclosing block."""
    token = _PLAIN.set(plain)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def runs_kernel(t) -> bool:
    """Whether a kernel wrapper called on tensor ``t`` launches its kernel:
    ``t`` is off the CPU (a CUDA tensor, or in the tests a ``meta`` one
    standing in for it) and no ``plain_kernels()`` block is open."""
    return t.device.type != 'cpu' and not _PLAIN.get()
