"""The one generator of every traffic mix: it reads the parameters of a mix
(``kgbench/traffic/<name>.json``) and makes the cell's inputs from the seed.

Each seed gets the same sizes and the same arrival gaps, in an order of its
own, and pixels of its own: the work of a run does not depend on the seed.
"""
from __future__ import annotations

import numpy as np


def rng(seed, stream):
    """A NumPy generator for one use of the seed (any whole number)."""
    return np.random.default_rng([int(seed) % 2 ** 63, stream])


def keep_ratio(h, w, img_scale):
    """The resized extents and the scale factor of an (h, w) image fitted
    into (long, short) with its aspect kept, rounded as mmcv rounds."""
    long_side, short_side = max(img_scale), min(img_scale)
    sf = min(long_side / max(h, w), short_side / min(h, w))
    return int(h * sf + 0.5), int(w * sf + 0.5), sf


def canvas_for(canvases, rh, rw):
    """The smallest canvas that holds a resized (rh, rw) image."""
    fits = [tuple(c) for c in canvases if c[0] >= rh and c[1] >= rw]
    if not fits:
        raise ValueError(f'no canvas holds {rh}x{rw}')
    return min(fits, key=lambda c: c[0] * c[1])


def source_sizes(mix):
    """The mix's source image sizes (h, w): each landscape size of
    ``sizes`` and, with ``portrait``, its transpose as well."""
    sizes = [tuple(s) for s in mix['sizes']]
    if mix.get('portrait'):
        sizes += [(w, h) for h, w in sizes]
    return sizes


def offline_batches(mix, data, seed):
    """Batches as the evaluation loader yields them: uint8 BGR images
    resized and zero-padded to their canvas, with their resized extents and
    scale factors. ``mix['pool_batches']`` batches of ``mix['batch']``
    images, each batch on one canvas, every source size used equally often.
    Returns (batches, order): host numpy batches and the seeded order the
    window cycles through."""
    g = rng(seed, 1)
    sizes = source_sizes(mix)
    B, n = mix['batch'], mix['pool_batches']
    if (B * n) % len(sizes):
        raise ValueError('pool_batches * batch must be a multiple of the '
                         'number of source sizes')
    picks = g.permutation(np.repeat(np.arange(len(sizes)),
                                    B * n // len(sizes)))
    by_canvas = {}
    for i in picks:
        h, w = sizes[i]
        rh, rw, sf = keep_ratio(h, w, data['img_scale'])
        by_canvas.setdefault(canvas_for(data['canvases'], rh, rw),
                             []).append((rh, rw, sf))
    batches = []
    for canvas in sorted(by_canvas):
        items = by_canvas[canvas]
        if len(items) % B:
            raise ValueError(f'{len(items)} images on canvas {canvas} do not '
                             f'fill batches of {B}')
        for lo in range(0, len(items), B):
            img = np.zeros((B,) + canvas + (3,), np.uint8)
            hw = np.zeros((B, 2), np.float32)
            sf = np.zeros((B,), np.float32)
            for j, (rh, rw, s) in enumerate(items[lo:lo + B]):
                img[j, :rh, :rw] = g.integers(0, 256, (rh, rw, 3), np.uint8)
                hw[j], sf[j] = (rh, rw), s
            batches.append({'image': img, 'img_hw': hw, 'scale_factor': sf})
    return batches, [int(i) for i in g.permutation(len(batches))]


def open_loop(mix, seed, seconds):
    """Requests of an open loop: (images, due, which). ``images`` is a pool
    of ``mix['pool']`` uint8 BGR source images, every size of the mix used
    equally often; ``due`` the seconds from the window's start at which each
    request is due, a Poisson process at ``mix['rate_per_s']``; ``which``
    the pool image of each request. The n + 1 gaps around the n arrivals
    are one fixed draw (``mix['gap_seed']``), scaled to span the window
    exactly, and only their order comes from the seed, as does the order of
    the images."""
    g = rng(seed, 2)
    sizes = source_sizes(mix)
    n_pool = mix['pool']
    if n_pool % len(sizes):
        raise ValueError('pool must be a multiple of the number of sizes')
    kinds = g.permutation(np.repeat(np.arange(len(sizes)),
                                    n_pool // len(sizes)))
    images = [g.integers(0, 256, sizes[k] + (3,), np.uint8) for k in kinds]
    n = max(1, round(mix['rate_per_s'] * seconds))
    gaps = g.permutation(np.random.default_rng(mix['gap_seed']).exponential(
        1.0, n + 1))
    due = np.cumsum(gaps)[:-1] * (seconds / gaps.sum())
    which = g.permutation(np.resize(np.arange(n_pool), n))
    return images, due, which


def sample(seed, population, k, always=()):
    """``k`` members of ``population`` drawn from the seed, with those of
    ``always`` among them."""
    g = rng(seed, 3)
    rest = [p for p in population if p not in always]
    extra = [rest[i] for i in g.permutation(len(rest))[:max(0, k - len(
        always))]]
    return sorted(set(always) | set(extra))


def train_set(mix, seed, root):
    """A DeepFashion2-format training set under ``root``: ``mix['files']``
    seeded JPEGs (every size of the mix equally often; smooth colour fields
    with a tiled grain, about a photograph's size on disk) and
    ``mix['records']`` image records that reuse them, each with 1 to 4
    garments (the counts of ``mix['garments']`` in a seeded order) of a
    uniform class, a box inside the image and every landmark of its class
    visible inside the box. Returns (annotation file, image folder,
    records as dicts of file, width, height and anns, file names)."""
    import json
    import os

    import cv2

    from kgbench.reference.deepfashion2 import CLASS_KEYPOINT_RANGES
    g = rng(seed, 4)
    sizes = source_sizes(mix)
    n_files = mix['files']
    kinds = g.permutation(np.repeat(np.arange(len(sizes)),
                                    n_files // len(sizes)))
    folder = os.path.join(root, 'image')
    os.makedirs(folder)
    grain = g.integers(-12, 13, (64, 64, 3)).astype(np.int16)
    names = []
    for f, k in enumerate(kinds):
        h, w = sizes[k]
        field = g.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3), np.uint8)
        img = cv2.resize(field, (w, h), interpolation=cv2.INTER_CUBIC)
        img = np.clip(img + np.tile(grain, (h // 64 + 1, w // 64 + 1, 1))
                      [:h, :w], 0, 255).astype(np.uint8)
        names.append(f'{f:05d}.jpg')
        cv2.imwrite(os.path.join(folder, names[-1]), img,
                    [cv2.IMWRITE_JPEG_QUALITY, mix['jpeg_quality']])
    counts = g.permutation(np.resize(mix['garments'], mix['records']))
    files = g.permutation(np.resize(np.arange(n_files), mix['records']))
    images, anns, records = [], [], []
    for r in range(mix['records']):
        f = int(files[r])
        h, w = sizes[kinds[f]]
        rec = {'file': f, 'width': w, 'height': h, 'anns': []}
        for _ in range(int(counts[r])):
            c = int(g.integers(1, 14))
            bw = int(g.integers(w // 5, w * 9 // 10))
            bh = int(g.integers(h // 5, h * 9 // 10))
            x, y = int(g.integers(0, w - bw)), int(g.integers(0, h - bh))
            kp = np.zeros((294, 3), np.int64)
            lo, hi = CLASS_KEYPOINT_RANGES[c]
            kp[lo:hi, 0] = g.integers(x, x + bw, hi - lo)
            kp[lo:hi, 1] = g.integers(y, y + bh, hi - lo)
            kp[lo:hi, 2] = 2
            a = {'id': len(anns) + 1, 'image_id': r + 1, 'category_id': c,
                 'bbox': [x, y, bw, bh], 'area': bw * bh, 'iscrowd': 0,
                 'keypoints': kp.reshape(-1).tolist()}
            anns.append(a)
            rec['anns'].append(a)
        images.append({'id': r + 1, 'file_name': names[f], 'width': w,
                       'height': h})
        records.append(rec)
    ann_file = os.path.join(root, 'train.json')
    with open(ann_file, 'w') as fh:
        json.dump({'images': images, 'annotations': anns,
                   'categories': [{'id': c, 'name': str(c)}
                                  for c in range(1, 14)]}, fh)
    return ann_file, folder, records, names
