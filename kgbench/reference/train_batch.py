"""Plain reference of a training batch and of the optimizer's step, as the
reference recipe (mmdetection v1 with mmcv) defines them.

Batches: images grouped by aspect (wider than tall, or not), each group
shuffled and cut into batches, the batches shuffled, all from a
``RandomState(seed + epoch)``; per image a ``RandomState`` of ``(seed *
1000003 + epoch * 9176 + index) mod 2**31`` draws the flip (``rand() <
flip_ratio``). An image is scaled by ``min(long / max(h, w), short /
min(h, w))`` (and no further than its canvas holds), resized bilinearly
to ``int(h * s + 0.5) x int(w * s + 0.5)``, flipped with its boxes
(``x' = w - x - 1``) and visible keypoints, whose left and right members
swap (DeepFashion2's pairs of the garment's class), and zero-padded to
the canvas of its group. Boxes come as ``[x, y, x + w - 1, y + h - 1]``;
at most ``max_gts`` garments an image.

Step: SGD with momentum on the gradient clipped to a global norm, plus
weight decay; the learning rate warms up linearly from ``warmup_ratio``
of its value over ``warmup_iters`` steps.
"""
from __future__ import annotations

import numpy as np
import torch

from kgbench.reference import deepfashion2
from kgbench.reference.preprocess import pad, resize_bilinear_u8


def epoch_batches(wide, batch, epoch, seed):
    """Record indices of each batch of an epoch; ``wide`` (N,) bool."""
    rng = np.random.RandomState(seed + epoch)
    out = []
    for g in np.unique(wide):
        idx = np.where(wide == g)[0]
        idx = idx[rng.permutation(len(idx))]
        if len(idx) % batch:
            if len(idx) >= batch:
                idx = idx[:len(idx) - len(idx) % batch]
            else:
                idx = np.concatenate([idx, rng.choice(idx,
                                                      batch - len(idx))])
        out += np.split(idx, len(idx) // batch)
    return [out[i] for i in rng.permutation(len(out))]


def flips(indices, epoch, seed, ratio):
    return [ratio > 0 and np.random.RandomState(
        (seed * 1000003 + epoch * 9176 + int(i)) % 2 ** 31).rand() < ratio
        for i in indices]


def sample(pixels, anns, flip, canvas, img_scale, max_gts, dtype):
    """One image's arrays: uint8 BGR canvas, resized (h, w), and padded
    boxes (G, 4), labels (G,), keypoints (G, 294, 3), mask (G,), computed
    in ``dtype``."""
    h0, w0 = pixels.shape[:2]
    long_side, short_side = max(img_scale), min(img_scale)
    s = min(long_side / max(h0, w0), short_side / min(h0, w0),
            canvas[0] / h0, canvas[1] / w0)
    rh, rw = int(h0 * s + 0.5), int(w0 * s + 0.5)
    img = resize_bilinear_u8(pixels, rh, rw)
    n = min(len(anns), max_gts)
    boxes = np.zeros((max_gts, 4), np.float32)
    labels = np.zeros((max_gts,), np.int64)
    kpts = np.zeros((max_gts, deepfashion2.NUM_KEYPOINTS, 3), np.float32)
    mask = np.zeros((max_gts,), bool)
    sf = torch.tensor(s, dtype=torch.float32).to(dtype)
    for j, a in enumerate(anns[:n]):
        x, y, w, h = a['bbox']
        box = torch.tensor([x, y, x + w - 1, y + h - 1],
                           dtype=torch.float32).to(dtype) * sf
        kp = torch.tensor(a['keypoints'], dtype=torch.float32).reshape(
            -1, 3)
        vis = kp[:, 2] > 0
        xy = torch.where(vis[:, None], kp[:, :2].to(dtype) * sf,
                         kp[:, :2].to(dtype))
        if flip:
            box = torch.stack([rw - box[2] - 1, box[1], rw - box[0] - 1,
                               box[3]])
            xy[:, 0] = torch.where(vis, rw - xy[:, 0] - 1, xy[:, 0])
            perm = torch.arange(len(kp))
            for p, q in deepfashion2.flip_pairs(a['category_id']):
                perm[p], perm[q] = q, p
            xy, vis_v = xy[perm], kp[perm, 2]
        else:
            vis_v = kp[:, 2]
        boxes[j] = box.float().numpy()
        labels[j] = a['category_id']
        kpts[j, :, :2] = xy.float().numpy()
        kpts[j, :, 2] = vis_v.numpy()
        mask[j] = True
    if flip:
        img = np.ascontiguousarray(img[:, ::-1])
    return (pad(img, canvas), (rh, rw), boxes, labels, kpts, mask)


def batch(records, pixels, indices, flip, canvases, img_scale, max_gts,
          dtype=torch.float32):
    """The batch of records ``indices``: a dict of numpy arrays as the
    training step takes it."""
    items = []
    for i, f in zip(indices, flip):
        r = records[i]
        canvas = tuple(canvases[0] if r['width'] / r['height'] > 1
                       else canvases[1])
        items.append(sample(pixels[r['file']], r['anns'], f, canvas,
                            img_scale, max_gts, dtype))
    keys = ('image', 'valid_hw', 'gt_bboxes', 'gt_labels', 'gt_kpts',
            'gt_mask')
    return {k: np.stack([np.asarray(it[j]) for it in items])
            for j, k in enumerate(keys)}


def lr_at(step, optim):
    frac = min(step / optim['warmup_iters'], 1.0)
    return optim['lr'] * (1 - (1 - frac) * (1 - optim['warmup_ratio']))


@torch.no_grad()
def sgd_step(params, grads, momentum, step, optim):
    """One update in place of the free parameters (name -> tensor);
    returns the global gradient norm before clipping."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    scale = optim['grad_clip_norm'] / torch.clamp(norm,
                                                  min=optim['grad_clip_norm'])
    lr = lr_at(step, optim)
    for name, p in params.items():
        g = grads[name] * scale + optim['weight_decay'] * p
        momentum[name] = optim['momentum'] * momentum.get(
            name, torch.zeros_like(p)) + g
        p -= lr * momentum[name]
    return norm
