"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the card's published peaks, the least time of the head's
deformable kernels at a cell's shapes, and the model's operations counted
over the benchmark's own reference.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s in
bfloat16, 3.35 TB/s of HBM. The kernel formulas are PERF.md's bound
arithmetic of the port's kernels (its section on findings), taken from the
shapes of the configuration, never from the program's call arguments: a
bilinear sample is 7 operations a value, a contraction 2 a multiply-add,
the sampling backward 26 a sampled value; each input read once and each
output written once.
"""
from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_seconds(ops, n_bytes, peak_flops=PEAK_BF16_FLOPS):
    """The larger of the compute bound and the memory bound."""
    return max(ops / peak_flops, n_bytes / PEAK_HBM_BYTES)


def head_map(model, canvas):
    """(h, w) of the head's level for a canvas (one level of stride s)."""
    s = model['head']['point_strides'][0]
    return math.ceil(canvas[0] / s), math.ceil(canvas[1] / s)


def k1_calls(model, batch, canvas, elem=2):
    """(operations, bytes) of each K1 call of a served forward: per
    deformable stage (2 and 3), per branch (class, points) and per column
    of taps, one fused gather and contraction over the whole level."""
    h, w = head_map(model, canvas)
    C = F = model['head']['feat_channels']
    P = h * w
    calls = []
    for _stage in (2, 3):
        for _branch in ('cls', 'pts'):
            for t in model['head']['column_taps']:
                ops = 2 * batch * P * t * C * F + 7 * batch * P * t * C
                n_bytes = (elem * batch * P * C + 4 * batch * P * t * 2
                           + elem * t * C * F + elem * batch * P * F)
                calls.append((ops, n_bytes))
    return calls


def k3_calls(model, batch, canvas, elem=2):
    """(operations, bytes) of each K3 call of a training step: per
    deformable stage one sampling backward over both branches' columns
    (2C channels, all taps)."""
    h, w = head_map(model, canvas)
    C2 = 2 * model['head']['feat_channels']
    P, R = h * w, sum(model['head']['column_taps'])
    g = batch * P * R * C2
    map_bytes = elem * batch * P * C2
    return [(26 * g, 2 * map_bytes + elem * g + 8 * batch * P * R * 2)
            for _stage in (2, 3)]


def least_seconds_of(calls):
    return sum(least_seconds(ops, n_bytes) for ops, n_bytes in calls)


def model_flops(forward, *args, **kwargs):
    """Operations of ``forward(*args, **kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (convolutions
    and matrix products, 2 a multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        forward(*args, **kwargs)
    return counter.get_total_flops()
