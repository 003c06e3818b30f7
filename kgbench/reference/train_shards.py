"""Plain reference of data-parallel training as the program reduces it
across processes (``parallel/dist.py``): the batch of each process at each
step, and the count each process's loss terms are divided by.

Sampling: the epoch's batches are those of ``train_batch.epoch_batches``
at each process's batch (the configuration's batch over the processes);
process r takes batches r, r + world, r + 2 world, ..., so the step's
images lie on up to ``world`` canvases.

Loss: each process divides its loss terms by the positive count of the
whole step (the program sums the count over the processes before it
divides), and the gradients and the losses are summed over the processes.
The step's loss is then the sum over processes of each one's
``point_loss.loss`` (at its own count) times its count's share of the
step's (``train_ddp.reference_steps``).
"""
from __future__ import annotations

import math

import torch

from kgbench.reference import point_loss, train_batch


def shard_picks(wide, world, per_process, steps, seed):
    """Record indices of each process's batch at each of the first
    ``steps`` steps: [step][process] -> indices."""
    batches = train_batch.epoch_batches(wide, per_process, 0, seed)
    return [[batches[k * world + r] for r in range(world)]
            for k in range(steps)]


def positive_count(batch, model, canvas):
    """The count ``point_loss.loss`` divides one process's terms by: each
    image's positive cells of each level, at least 1 an image a level."""
    h_cfg, L = model['head'], model['loss']
    dev = batch['valid_hw'].device
    total = 0
    for stride in h_cfg['point_strides']:
        h, w = math.ceil(canvas[0] / stride), math.ceil(canvas[1] / stride)
        xy = point_loss.cells(h, w, stride, dev)
        valid = point_loss.valid_cells(h, w, stride, batch['valid_hw'])
        total = total + point_loss.targets(
            xy, stride, valid, batch, L['assign_scale'],
            L['pos_num'])['num_pos'].sum()
    return total.float()

