"""K6's least time in a served HTC batch, from the configuration's shapes
alone (frozen here, as ``roofline.py`` is, so that a change to the program
cannot move it).

HTC gathers RoIs eight times a forward: each of the three box stages'
RoIs at 7 x 7 on the FPN levels and on the semantic embedding (the fusion
level's map, stride 8), and the mask RoIs at 14 x 14 on both. Each gather
is counted as ``roofline_rcnn.py`` counts Faster R-CNN's: its maps read
once (``ceil(canvas / stride)`` a side, all channels) and the pooled
output of every RoI slot written, at the compute dtype; the operations
are the bilinear samples' (``out_size``^2 bins of ``sample_num``^2
samples a RoI, 7 a sampled value a channel). The gathers are links of a
chain (each stage's RoIs come from the stage before), so each reads its
maps anew.
"""
from __future__ import annotations

import math

from kgbench.roofline import least_seconds_of
from kgbench.roofline_rcnn import level_cells


def gather_work(cells, rois, out_size, sample_num, channels, elem):
    """(operations, bytes) of one gather of ``rois`` RoI slots from maps of
    ``cells`` cells in all."""
    ops = 7 * rois * (out_size * sample_num) ** 2 * channels
    return ops, elem * channels * (cells + rois * out_size ** 2)


def htc_gathers(model, batch, canvas):
    """(operations, bytes) of each RoI gather of a served batch on
    ``canvas``: per box stage the FPN levels and the semantic map at the
    box size, then both at the mask size."""
    elem = 2 if model['compute_dtype'] == 'bfloat16' else 4
    C = model['neck']['out_channels']
    s = model['semantic']['stride']
    levels = batch * level_cells(model, canvas)
    sem = batch * math.ceil(canvas[0] / s) * math.ceil(canvas[1] / s)
    n = model['roi']['sample_num']
    out = []
    for rois, size in ([(batch * model['rpn']['max_num'],
                         model['roi']['out_size'])]
                       * len(model['cascade']['stds'])
                       + [(batch * model['mask']['rois'],
                           model['mask']['out_size'])]):
        out += [gather_work(levels, rois, size, n, C, elem),
                gather_work(sem, rois, size, n, C, elem)]
    return out


def k6_least_seconds(model, batch, canvases):
    """The least time of a batch's gathers, averaged over the cell's
    canvases."""
    return sum(least_seconds_of(htc_gathers(model, batch, c))
               for c in canvases) / len(canvases)
