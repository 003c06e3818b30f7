"""K6's least time in a served two-stage batch, from the configuration's
shapes alone (frozen here, as ``roofline.py`` is, so that a change to the
program cannot move it).

The work the model asks of the RoI gather, counted as compulsory traffic:
each FPN level's map read once (``ceil(canvas / stride)`` a side, all
channels) and the pooled ``out_size`` x ``out_size`` x C output of every
proposal slot written, at the compute dtype; the operations are the
bilinear samples' (``out_size``^2 bins of ``sample_num``^2 samples a RoI,
7 a sampled value a channel). What an implementation happens to do (gather
every level, read a corner once for each sample that touches it, write the
samples before pooling them) is not counted: a gather that does less of it
reads as a higher share.
"""
from __future__ import annotations

import math

from kgbench.roofline import least_seconds


def level_cells(model, canvas):
    """Cells of all the FPN levels' maps of one image on ``canvas``."""
    return sum(math.ceil(canvas[0] / s) * math.ceil(canvas[1] / s)
               for s in model['rpn']['strides'][:model['neck']['num_outs']])


def k6_work(model, batch, canvas):
    """(operations, bytes) of a served batch's RoI gather on ``canvas``."""
    roi = model['roi']
    elem = 2 if model['compute_dtype'] == 'bfloat16' else 4
    rois = batch * model['rpn']['max_num']
    C = model['neck']['out_channels']
    ops = 7 * rois * (roi['out_size'] * roi['sample_num']) ** 2 * C
    n_bytes = elem * C * (batch * level_cells(model, canvas)
                          + rois * roi['out_size'] ** 2)
    return ops, n_bytes


def k6_least_seconds(model, batch, canvases):
    """The least time of a batch, averaged over the cell's canvases."""
    return sum(least_seconds(*k6_work(model, batch, c))
               for c in canvases) / len(canvases)
