"""The yardstick's arithmetic against numbers worked by hand at the
cells' shapes: kernel K1's least time in a served batch of 8, K3's in a
training step of 8, and the model operations that ``mfu.*`` counts over
the reference (on the meta device: no weights, no work)."""
import json
import os

import pytest
import torch

from kgbench import roofline
from kgbench.reference import kgdet_cascade
from kgbench.tests.tiny import ROOT

MODEL = json.load(open(os.path.join(
    ROOT, 'kgbench', 'configs', 'kgdet_cascade_r50.json')))['model']


@pytest.mark.parametrize('canvas', [(800, 1344), (1344, 800)])
def test_k1_least_time_batch_8(canvas):
    # 25 x 42 cells; per tap 2*8*1050*256*256 + 7*8*1050*256 operations;
    # 83 taps a branch and stage, 2 branches, 2 stages
    ops = 4 * 83 * (2 * 8 * 1050 * 256 * 256 + 7 * 8 * 1050 * 256)
    assert ops == 370_531_123_200
    calls = roofline.k1_calls(MODEL, 8, canvas)
    assert len(calls) == 12
    assert sum(o for o, _ in calls) == ops
    # every call is bound by compute: the largest is 49 taps
    assert calls[2][1] == 2 * (8 * 1050 * 256) * 2 + 4 * 8 * 1050 * 49 * 2 \
        + 2 * 49 * 256 * 256
    assert roofline.least_seconds_of(calls) == pytest.approx(ops / 989e12)
    assert roofline.least_seconds_of(calls) == pytest.approx(374.65e-6,
                                                             rel=1e-4)


def test_k3_least_time_step_of_8():
    # PERF.md's batch-8 bound of K3 at 800x1344: 0.2216 ms, bound by bytes
    g = 8 * 1050 * 83 * 512
    n_bytes = 2 * (2 * 8 * 1050 * 512) + 2 * g + 8 * 8 * 1050 * 83 * 2
    assert n_bytes == 742_291_200
    calls = roofline.k3_calls(MODEL, 8, (800, 1344))
    assert calls == [(26 * g, n_bytes)] * 2
    assert roofline.least_seconds_of(calls[:1]) == pytest.approx(
        0.2216e-3, rel=1e-3)


def _conv(cin, cout, k, h, w):
    return 2 * cin * cout * k * k * h * w


def hand_count(H, W):
    """The forward's multiply-adds, 2 each: R-50, the P5 path of the FPN,
    the head's convs, 1x1 outputs and deformable contractions."""
    h, w = H // 2, W // 2
    n = _conv(3, 64, 7, h, w)
    h, w = h // 2, w // 2
    cin = 64
    for s, (blocks, planes) in enumerate(zip((3, 4, 6, 3),
                                             (64, 128, 256, 512))):
        for i in range(blocks):
            h2, w2 = (h // 2, w // 2) if s and not i else (h, w)
            n += _conv(cin, planes, 1, h, w) + _conv(planes, planes, 3, h2,
                                                     w2)
            n += _conv(planes, 4 * planes, 1, h2, w2)
            if not i:
                n += _conv(cin, 4 * planes, 1, h2, w2)
            cin, h, w = 4 * planes, h2, w2
    n += _conv(2048, 256, 1, h, w) + _conv(256, 256, 3, h, w)
    n += 6 * _conv(256, 256, 3, h, w)
    out = (_conv(256, 13, 1, h, w) + _conv(256, 588, 1, h, w)
           + _conv(588, 166, 1, h, w))
    n += 2 * _conv(256, 256, 3, h, w) + out
    deform = 2 * 83 * 2 * 256 * 256 * h * w
    tail = (_conv(768, 13, 1, h, w) + _conv(768, 588, 1, h, w)
            + _conv(588, 166, 1, h, w))
    return n + 2 * (deform + tail)


@pytest.mark.parametrize('canvas', [(800, 1344), (1344, 800)])
def test_model_flops_of_the_reference(canvas):
    specs = kgdet_cascade.param_specs(MODEL)
    w = {k: torch.empty(shape, device='meta',
                        dtype=torch.int64 if kind == 'count'
                        else torch.float32)
         for k, (shape, kind, _) in specs.items()}
    x = torch.empty((1, 3) + canvas, device='meta')
    got = roofline.model_flops(kgdet_cascade.forward, w, x, MODEL)
    assert got == hand_count(*canvas) == 235_979_973_600
