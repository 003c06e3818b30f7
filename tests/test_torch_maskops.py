"""The port's RLE mask code (kgdet_tpu_torch/native/: maskops.cpp built with
g++ into kgdet_tpu_torch/build/) against kgdet_tpu/native/ on the same
masks, polygons and strings, case by case: every count, string, area, box
and IoU exactly equal. Also where the library is built, and that a missing
g++ raises naming it."""
import os

import numpy as np
import pytest

from kgdet_tpu import native as jnative
from kgdet_tpu_torch import native as tnative

H, W = 37, 53


def _masks(seed, n=4):
    """Blobs, an empty mask, a full one, stripes: runs of every length."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        m = np.zeros((H, W), np.uint8)
        y, x = rng.randint(0, H - 5), rng.randint(0, W - 5)
        m[y:y + rng.randint(3, 20), x:x + rng.randint(3, 30)] = 1
        m[rng.rand(H, W) < 0.05] ^= 1
        out.append(m)
    stripes = np.zeros((H, W), np.uint8)
    stripes[:, ::3] = 1
    return out + [np.zeros((H, W), np.uint8), np.ones((H, W), np.uint8),
                  stripes]


def _polys(seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform([-3, -3], [W + 3, H + 3], (k, 2)).reshape(-1)
            for k in (3, 5, 8)] + [np.asarray([2.5, 3.5, 30.2, 3.5, 30.2,
                                               20.7, 2.5, 20.7])]


def _pairs(seed):
    m = _masks(seed)
    return list(zip(m, m[1:] + m[:1]))


def _both(mod, case, seed):
    """What ``case`` gives with the RLE code of ``mod``, as plain data."""
    RLE = mod.RLE
    masks = _masks(seed)
    if case == 'encode':
        return [RLE.encode(m).counts.tolist() for m in masks]
    if case == 'decode':
        return [RLE.encode(m).decode().tolist() for m in masks]
    if case == 'area':
        return [RLE.encode(m).area() for m in masks]
    if case == 'bbox':
        return [RLE.encode(m).to_bbox().tolist() for m in masks]
    if case in ('merge', 'merge_intersect'):
        return [RLE.encode(a).merge(RLE.encode(b), case != 'merge')
                .counts.tolist() for a, b in _pairs(seed)]
    if case in ('iou', 'iou_crowd'):
        return [RLE.encode(a).iou(RLE.encode(b), case == 'iou_crowd')
                for a, b in _pairs(seed)]
    if case == 'string':
        out = []
        for m in masks:
            s = RLE.encode(m).to_string()
            back = RLE.from_string(s, H, W)
            out.append((s, back.counts.tolist(), back.decode().tolist()))
        return out
    if case == 'from_poly':
        return [RLE.from_poly(p, H, W).counts.tolist() for p in _polys(seed)]
    if case == 'mask_iou_matrix':
        d = [RLE.encode(m) for m in masks[:4]]
        g = [RLE.from_poly(p, H, W) for p in _polys(seed)]
        return mod.mask_iou_matrix(d, g, [False, True, False, True]) \
            .tolist()
    raise KeyError(case)


CASES = ('encode', 'decode', 'area', 'bbox', 'merge', 'merge_intersect',
         'iou', 'iou_crowd', 'string', 'from_poly', 'mask_iou_matrix')


@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('seed', [0, 1])
def test_rle_matches_jax_native(case, seed):
    """Each operation of the port's RLE equal to kgdet_tpu.native's."""
    got, want = _both(tnative, case, seed), _both(jnative, case, seed)
    assert got == want
    assert len(got) > 0


def test_invalid_counts_raise():
    bad = tnative.RLE(H, W, [5, 3])
    with pytest.raises(ValueError, match='do not cover'):
        bad.decode()


def test_library_builds_under_the_build_dir_and_needs_gxx(monkeypatch,
                                                         tmp_path):
    """The library of the current source lies in kgdet_tpu_torch/build/
    (git-ignored), keyed by the source's hash, never beside the source;
    a build without g++ raises naming it."""
    tnative._load()
    so = tnative.library_path()
    assert so.exists()
    assert so.parent.parent == tnative.BUILD
    assert so.parent.name.startswith('maskops-')
    assert not any(n.endswith('.so') for n in
                   os.listdir(os.path.dirname(tnative.SRC)))
    monkeypatch.setattr(tnative.shutil, 'which', lambda name: None)
    with pytest.raises(RuntimeError, match='g\\+\\+'):
        tnative.build(tmp_path / 'libmaskops.so')
    assert not (tmp_path / 'libmaskops.so').exists()
