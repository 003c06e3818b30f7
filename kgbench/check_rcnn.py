"""The numbers that decide ``correct`` for a two-stage detector, one a
stage, each comparing what the timed path produced with the plain
reference (``reference/faster_rcnn.py``, ``reference/rcnn_decode.py``); the
limits are in the configuration file, set from readings of sound runs and
of the control (PERF.md gives them).

- ``rpn_gap``: the RPN's outputs (objectness and deltas of every level)
  against the reference's float32 forward of the same inputs and weights;
- ``proposal_gap``: the proposals against the reference's, made from the
  program's own RPN outputs;
- ``roi_gap``: the box head's logits and deltas against the reference's
  RoI head on its float32 features at the program's own proposals;
- ``det_gap``: the detections against the reference decode of the
  program's own box head outputs and proposals.

``norm_gap`` is, per output, the norm of the difference over the norm of
the reference's deviation from its mean, the largest; the box gaps are the
largest coordinate difference over 1000 pixels (and for detections the
score difference), a slot whose presence (or class) differs counting 1.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def norm_gap(pairs):
    """pairs: (program, reference) tensors of one shape each."""
    worst = 0.0
    for p, r in pairs:
        p, r = p.double(), r.double().to(p.device)
        if p.shape != r.shape:
            return float('inf')
        ref = torch.linalg.vector_norm(r - r.mean())
        gap = float(torch.linalg.vector_norm(p - r) / ref.clamp(min=1e-30))
        if not math.isfinite(gap):
            return float('inf')
        worst = max(worst, gap)
    return worst


def rpn_pairs(program, reference):
    """Per level and output: program (1, B, h, w, X) or (B, h, w, X)
    against the reference's (B, h, w, X)."""
    return [(p[k].reshape(r[k].shape), r[k])
            for p, r in zip(program, reference, strict=True)
            for k in ('cls', 'bbox')]


def proposal_gap(p_props, p_valid, r_props, r_valid):
    """(B, R, 4) boxes and (B, R) presence of both sides."""
    p_valid, r_valid = np.asarray(p_valid, bool), np.asarray(r_valid, bool)
    if p_valid.shape != r_valid.shape or (p_valid != r_valid).any():
        return 1.0
    if not p_valid.any():
        return 0.0
    d = np.abs(np.asarray(p_props, np.float64)[p_valid]
               - np.asarray(r_props, np.float64)[r_valid]).max() / 1000.0
    return float(d) if math.isfinite(d) else 1.0


def det_gap(program, reference):
    """program, reference: per image (boxes (n, 5), labels (n,)) numpy,
    the valid detections in slot order."""
    worst = 0.0
    for (pb, pl), (rb, rl) in zip(program, reference, strict=True):
        if len(pb) != len(rb) or not np.array_equal(pl, rl):
            return 1.0
        if not len(pb):
            continue
        gap = float(max(np.abs(pb[:, :4] - rb[:, :4]).max() / 1000.0,
                        np.abs(pb[:, 4] - rb[:, 4]).max()))
        if not math.isfinite(gap):
            return 1.0
        worst = max(worst, gap)
    return worst


def valid_rows(det_bboxes, det_labels, valid):
    """Padded detections (B, M, ...) -> per image its valid rows."""
    return [(np.asarray(det_bboxes[b])[np.asarray(valid[b], bool)],
             np.asarray(det_labels[b])[np.asarray(valid[b], bool)])
            for b in range(len(valid))]
