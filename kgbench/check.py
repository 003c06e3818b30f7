"""The numbers that decide ``correct``: each compares what the timed path
produced with the plain reference, and has a limit of its own, set in the
configuration file from readings of sound runs and of the control
(PERF.md gives the readings).

- ``head_gap``: the head outputs (class logits, keypoint offsets, boxes of
  all three stages) of the program against the reference's float32 forward
  of the same inputs and weights: per output the norm of the difference
  over the norm of the reference's deviation from its mean, the largest.
- ``det_gap``: the program's detections against the reference decode of the
  program's own head outputs: per detection the largest coordinate
  difference over 1000 pixels and the score difference, the largest; a
  detection whose presence or class differs counts 1.
"""
from __future__ import annotations

import math

import numpy as np
import torch

HEAD_KEYS = ('cls', 'kpt', 'bbox')


def head_gap(program_levels, reference_levels):
    worst = 0.0
    for p_lvl, r_lvl in zip(program_levels, reference_levels, strict=True):
        for key in HEAD_KEYS:
            for p, r in zip(p_lvl[key], r_lvl[key], strict=True):
                p, r = p.double(), r.double().to(p.device)
                if p.shape != r.shape:
                    return float('inf')
                ref = torch.linalg.vector_norm(r - r.mean())
                gap = float(torch.linalg.vector_norm(p - r)
                            / ref.clamp(min=1e-30))
                if not math.isfinite(gap):
                    return float('inf')
                worst = max(worst, gap)
    return worst


def det_gap(program, reference):
    """program, reference: per image (boxes (n, 5), labels (n,), kpts
    (n, 3K)) numpy, the valid detections in slot order."""
    worst = 0.0
    for (pb, pl, pk), (rb, rl, rk) in zip(program, reference, strict=True):
        if len(pb) != len(rb) or not np.array_equal(pl, rl):
            return 1.0
        if not len(pb):
            continue
        px = np.max([np.abs(pb[:, :4] - rb[:, :4]).max(),
                     np.abs(pk.reshape(len(pk), -1, 3)[..., :2]
                            - rk.reshape(len(rk), -1, 3)[..., :2]).max()])
        gap = float(np.max([px / 1000.0, np.abs(pb[:, 4] - rb[:, 4]).max()]))
        if not math.isfinite(gap):
            return 1.0
        worst = max(worst, gap)
    return worst


def valid_rows(det_bboxes, det_labels, det_kpts, valid):
    """Padded detections (B, M, ...) -> per image its valid rows."""
    return [(det_bboxes[b][valid[b]], det_labels[b][valid[b]],
             det_kpts[b][valid[b]]) for b in range(len(valid))]


def judge(readings, limits):
    """(correct, [(name, value, limit)]): correct when every reading is at
    or under its limit."""
    rows = [(name, readings[name], limits[name]) for name in sorted(limits)]
    return all(v <= lim for _, v, lim in rows), rows
