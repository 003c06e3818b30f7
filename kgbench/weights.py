"""Seeded weights, made on the device in two draws.

Every floating entry of a reference's ``param_specs`` takes its slice of one
standard-normal and one uniform draw of a ``torch.Generator`` on the device:

- ``weight``: normal with variance 1 / fan_in, so that each layer keeps the
  scale of its input and the head's offsets come out at about a cell;
- ``shift`` (biases, BatchNorm means and biases, GroupNorm biases, the
  moment transfer): normal, standard deviation 0.1;
- ``scale`` (BatchNorm and GroupNorm weights): uniform on [0.75, 1.25];
- ``var`` (BatchNorm variances): uniform on [0.5, 1.5];
- ``prior`` (class logits' biases): the focal prior log(0.01 / 0.99) plus a
  normal of standard deviation 0.1;
- ``count``: an int64 zero.

The same seed gives the same weights; the program and the reference are
both handed them.
"""
from __future__ import annotations

import math

import torch

PRIOR = math.log(0.01 / 0.99)


def make(specs, seed, device):
    """name -> float32 tensor on ``device`` for every entry of ``specs``."""
    sizes = {n: math.prod(shape) for n, (shape, kind, _) in specs.items()
             if kind != 'count'}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(sizes.values())
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, lo = {}, 0
    for name, (shape, kind, fan_in) in specs.items():
        if kind == 'count':
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = sizes[name]
        z = normal[lo:lo + n].view(shape)
        u = uniform[lo:lo + n].view(shape)
        lo += n
        if kind == 'weight':
            t = z / math.sqrt(fan_in)
        elif kind == 'shift':
            t = 0.1 * z
        elif kind == 'scale':
            t = 0.75 + 0.5 * u
        elif kind == 'var':
            t = 0.5 + u
        elif kind == 'prior':
            t = PRIOR + 0.1 * z
        else:
            raise ValueError(f'{name}: unknown kind {kind!r}')
        out[name] = t
    return out
