"""The port's data pipeline against the JAX package's, array for array.

``kgdet_tpu_torch.data`` (image_io, transforms, dataset, loader) is held
against ``kgdet_tpu.data`` on the files of tests/test_data.py
(``make_synth_coco``, ``make_crowd_coco``) and the same seeds: every
transform, augmentation, sample and batch must be array-equal. The port's
own image reader and resize (``image_io.np_imread`` / ``np_imresize``, what
runs where OpenCV is absent) are held against ``cv2`` bit for bit: the
resize on a grid of up, down and same sizes, uint8 bit-equal; float32
bit-equal except for sources one pixel high or wide, and float64, within
1e-4 of a grey level, where OpenCV's float path rounds in an order NumPy
cannot take.
"""
import dataclasses
import os
import pickle
import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip('cv2')

from kgdet_tpu.config import DataConfig as JDataConfig
from kgdet_tpu.data import dataset as jdataset
from kgdet_tpu.data import loader as jloader
from kgdet_tpu.data import transforms as jtf
from kgdet_tpu_torch.config import DataConfig as TDataConfig
from kgdet_tpu_torch.data import dataset as tdataset
from kgdet_tpu_torch.data import image_io
from kgdet_tpu_torch.data import loader as tloader
from kgdet_tpu_torch.data import transforms as ttf
from kgdet_tpu_torch.data.deepfashion2_meta import (
    CLASS_KEYPOINT_RANGES, NUM_KEYPOINTS)
from tests.test_data import make_crowd_coco, make_synth_coco


# ------------------------------------------------------------------ helpers
def assert_same(a, b, what=''):
    """Array-equal with the same dtype, through dicts and tuples."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            assert_same(a[k], b[k], f'{what}.{k}')
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{what}[{i}]')
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=what)


def both(**kw):
    return JDataConfig(**kw), TDataConfig(**kw)


def png_chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body +
            struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter_row(ftype, line, prev, bpp):
    line = line.astype(np.int32)
    prev = prev.astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = prev
    elif ftype == 3:
        pred = (left + prev) >> 1
    else:
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, prev, upleft))
    return ((line - pred) & 0xFF).astype(np.uint8)


def write_png_all_filters(path, px, color, palette=None):
    """A PNG whose row y uses filter type y % 5 (libpng's writer picks its
    own), so the reader's five unfilter paths all run."""
    h, w, c = px.shape
    stride = w * c
    raw, prev = [], np.zeros(stride, np.uint8)
    for y in range(h):
        line = px[y].reshape(-1)
        raw.append(bytes([y % 5]) + _filter_row(y % 5, line, prev,
                                                 c).tobytes())
        prev = line
    data = b'\x89PNG\r\n\x1a\n' + png_chunk(
        b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color, 0, 0, 0))
    if palette is not None:
        data += png_chunk(b'PLTE', palette.tobytes())
    data += png_chunk(b'IDAT', zlib.compress(b''.join(raw)))
    data += png_chunk(b'IEND', b'')
    with open(path, 'wb') as f:
        f.write(data)


# ----------------------------------------------------------------- image_io
def test_backend_is_cv2_where_it_imports():
    assert image_io.BACKEND == 'cv2'


@pytest.mark.parametrize('name,shape', [
    ('grey.png', (37, 53)), ('rgb.png', (37, 53, 3)),
    ('rgba.png', (37, 53, 4)), ('rgb.ppm', (37, 53, 3)),
    ('grey.pgm', (37, 53)), ('smooth.png', (90, 130, 3))])
def test_imread_matches_cv2_on_files_cv2_writes(tmp_path, name, shape):
    rng = np.random.RandomState(len(name))
    if name.startswith('smooth'):
        ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1]))
        img = np.stack([ramp, ramp * 3, 255 - ramp], -1) % 256
        img = img.astype(np.uint8)
    else:
        img = rng.randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / name)
    assert cv2.imwrite(path, img)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert_same(image_io.np_imread(path), want, name)
    assert_same(image_io.imread(path), want, name)


@pytest.mark.parametrize('color', [0, 2, 3, 4, 6])
def test_imread_unfilters_all_five_filter_types(tmp_path, color):
    """Grey, RGB, palette, grey + alpha and RGBA, every row filtered in
    turn with None / Sub / Up / Average / Paeth."""
    rng = np.random.RandomState(color)
    c = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    ramp = (np.add.outer(np.arange(23), np.arange(31)) * 7) % 256
    px = (ramp[..., None] + rng.randint(0, 40, (23, 31, c))) % 256
    palette = None
    if color == 3:
        palette = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    px = px.astype(np.uint8)
    path = str(tmp_path / f'filters_{color}.png')
    write_png_all_filters(path, px, color, palette)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert want is not None
    assert_same(image_io.np_imread(path), want, f'color type {color}')


def test_imread_raises_naming_cv2(tmp_path):
    jpg = str(tmp_path / 'x.jpg')
    cv2.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    png16 = str(tmp_path / 'x16.png')
    cv2.imwrite(png16, np.zeros((8, 8, 3), np.uint16))
    laced = str(tmp_path / 'laced.png')
    with open(laced, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + png_chunk(
            b'IHDR', struct.pack('>IIBBBBB', 8, 8, 8, 2, 0, 0, 1)))
    for path in (jpg, png16, laced):
        with pytest.raises(image_io.ImageDecodeError, match='cv2'):
            image_io.np_imread(path)
    junk = str(tmp_path / 'junk.png')
    with open(junk, 'wb') as f:
        f.write(b'not an image')
    for read in (image_io.imread, image_io.np_imread):
        with pytest.raises(image_io.ImageDecodeError, match='cv2'):
            read(junk)
    with pytest.raises(FileNotFoundError):
        image_io.np_imread(str(tmp_path / 'missing.png'))
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / 'missing.png'))


SOURCES = [(120, 160), (160, 120), (37, 53), (5, 7), (1, 9), (9, 1),
           (333, 517), (800, 1333)]


def _targets(H, W):
    return [(H * 2 + 3, W * 2 - 1), (max(H // 2, 1), max(W // 2, 1)),
            (max(int(H * .75), 1), max(int(W * .75), 1)), (H, W),
            (int(H * 1.333) + 1, int(W * 1.333) + 1),
            (max(H // 3, 1), max(W // 3, 1)), (7, 3), (1, 1)]


@pytest.mark.parametrize('dtype', ['uint8', 'float32', 'float64'])
def test_imresize_matches_cv2_inter_linear(dtype):
    """Grid of sources x (up, 2x down, 3/4, same, 4/3, 3x down, tiny)
    sizes x 1, 3 and 4 channels and a 2-D image. uint8 must be bit-equal;
    float32 is bit-equal but for sources one pixel high or wide; the
    float paths stay within 1e-4 of a grey level."""
    rng = np.random.RandomState(3)
    worst, n = 0.0, 0
    for H, W in SOURCES:
        for c in (0, 1, 3, 4):
            img = (rng.rand(H, W, max(c, 1)) * 255).astype(dtype)
            if c == 0:
                img = img[..., 0]
            for h, w in _targets(H, W):
                want = cv2.resize(img, (w, h),
                                  interpolation=cv2.INTER_LINEAR)
                got = image_io.np_imresize(img, (w, h))
                assert got.shape == want.shape and got.dtype == want.dtype
                err = np.abs(got.astype(np.float64) - want).max()
                if dtype == 'uint8' or (dtype == 'float32' and
                                        min(H, W) > 1):
                    assert err == 0, (H, W, c, h, w, err)
                worst = max(worst, err)
                n += 1
    assert n == len(SOURCES) * 4 * 8
    assert worst <= 1e-4


def test_imresize_of_a_dataset_sized_image_is_bit_equal():
    img = np.random.RandomState(5).randint(0, 256, (900, 1200, 3)) \
        .astype(np.uint8)
    for size in ((1333, 1000), (1067, 800), (667, 500)):
        assert_same(image_io.np_imresize(img, size),
                    cv2.resize(img, size, interpolation=cv2.INTER_LINEAR))


# --------------------------------------------------------------- transforms
def test_transforms_match_jax():
    rng = np.random.RandomState(0)
    for h, w in ((600, 1000), (1000, 600), (2000, 3000), (37, 53)):
        assert ttf.keep_ratio_scale(h, w, (1333, 800)) == \
            jtf.keep_ratio_scale(h, w, (1333, 800))
        sf = ttf.keep_ratio_scale(h, w, (1333, 800))
        assert ttf.rescale_size(h, w, sf) == jtf.rescale_size(h, w, sf)
    img = rng.randint(0, 256, (57, 83, 3)).astype(np.uint8)
    for scale in ((128, 96), (1333, 800), (40, 30)):
        got, want = ttf.imrescale(img, scale), jtf.imrescale(img, scale)
        assert_same(got[0], want[0])
        assert got[1] == want[1]
    assert_same(ttf.imnormalize(img), jtf.imnormalize(img))
    assert_same(ttf.imnormalize(img, to_rgb=False),
                jtf.imnormalize(img, to_rgb=False))
    assert_same(ttf.pad_to_canvas(img, (64, 96)),
                jtf.pad_to_canvas(img, (64, 96)))
    for div in (32, 8):
        assert_same(ttf.pad_to_divisor(img, div), jtf.pad_to_divisor(img, div))
    boxes = rng.uniform(0, 80, (6, 4)).astype(np.float32)
    assert_same(ttf.flip_bboxes(boxes, 83), jtf.flip_bboxes(boxes, 83))
    labels = np.arange(1, 14)
    kpts = np.zeros((13, NUM_KEYPOINTS, 3), np.float32)
    for i, lab in enumerate(labels):
        s, e = CLASS_KEYPOINT_RANGES[lab]
        kpts[i, s:e, :2] = rng.uniform(0, 82, (e - s, 2))
        kpts[i, s:e, 2] = rng.randint(0, 3, e - s)
    assert_same(ttf.flip_keypoints(kpts, labels, 83),
                jtf.flip_keypoints(kpts, labels, 83))
    a = rng.uniform(0, 50, (5, 4))
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 50, (3, 4))
    b[:, 2:] += b[:, :2]
    assert_same(ttf._iou_xyxy(a, b), jtf._iou_xyxy(a, b))


def _annotations(rng, n, h, w):
    x1 = rng.uniform(0, w / 2, n)
    y1 = rng.uniform(0, h / 2, n)
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, w / 2, n),
                      y1 + rng.uniform(8, h / 2, n)], 1).astype(np.float32)
    labels = rng.randint(1, 14, n)
    kpts = np.zeros((n, NUM_KEYPOINTS, 3), np.float32)
    kpts[..., 0] = rng.uniform(0, w, (n, NUM_KEYPOINTS))
    kpts[..., 1] = rng.uniform(0, h, (n, NUM_KEYPOINTS))
    kpts[..., 2] = rng.randint(0, 3, (n, NUM_KEYPOINTS))
    return boxes, labels, kpts


def test_augmentations_match_jax_draw_for_draw():
    """PhotoMetricDistortion, Expand and RandomCrop on the same inputs and
    seeds: the same arrays, and the generators left in the same state."""
    img = np.random.RandomState(1).randint(0, 256, (60, 90, 3)) \
        .astype(np.uint8)
    augs = ((ttf.PhotoMetricDistortion(), jtf.PhotoMetricDistortion()),
            (ttf.Expand(), jtf.Expand()), (ttf.RandomCrop(),
                                           jtf.RandomCrop()))
    for seed in range(12):
        boxes, labels, kpts = _annotations(np.random.RandomState(seed), 3,
                                           60, 90)
        ignore = boxes[:1] + 2
        for k, (port, ref) in enumerate(augs):
            r_port = np.random.RandomState(seed)
            r_ref = np.random.RandomState(seed)
            if k == 0:
                got, want = port(img, r_port), ref(img, r_ref)
            elif k == 1:
                got = port(img, boxes, kpts, r_port, ignore=ignore)
                want = ref(img, boxes, kpts, r_ref, ignore=ignore)
            else:
                got = port(img, boxes, labels, kpts, r_port, ignore=ignore)
                want = ref(img, boxes, labels, kpts, r_ref, ignore=ignore)
            assert_same(got, want, f'aug {k} seed {seed}')
            assert r_port.randint(1 << 30) == r_ref.randint(1 << 30)


def test_photometric_distortion_names_cv2_without_it(monkeypatch):
    monkeypatch.setattr(image_io, 'cv2', None)
    with pytest.raises(ImportError, match='cv2'):
        ttf.PhotoMetricDistortion()(np.zeros((4, 4, 3), np.uint8),
                                    np.random.RandomState(0))


def test_apply_keypoint_groups_matches_jax():
    rng = np.random.RandomState(0)
    kpts = rng.uniform(0, 50, (4, NUM_KEYPOINTS, 3)).astype(np.float32)
    kpts[..., 2] = rng.rand(4, NUM_KEYPOINTS) > 0.8
    assert_same(tdataset.apply_keypoint_groups(kpts),
                jdataset.apply_keypoint_groups(kpts))


# ------------------------------------------------------------------ dataset
@pytest.fixture(scope='module')
def synth_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('torch_synth'))
    return d, make_synth_coco(d, n_images=10), make_crowd_coco(d)


def _datasets(d, ann, train, **kw):
    base = dict(ann_file=ann, img_prefix=d, img_scale=(128, 96), max_gts=8,
                canvas_hw=((96, 128), (128, 96)))
    base.update(kw)
    jc, tc = both(**base)
    return (jdataset.DeepFashion2Dataset(jc, train=train),
            tdataset.DeepFashion2Dataset(tc, train=train))


def test_records_flags_and_annotations_match(synth_dir):
    d, ann, crowd = synth_dir
    for a in (ann, crowd):
        for train in (True, False):
            jds, tds = _datasets(d, a, train)
            assert len(jds) == len(tds)
            assert [dataclasses.astuple(r) for r in jds.records] == \
                [dataclasses.astuple(r) for r in tds.records]
            assert_same(tds.flags, jds.flags)
            assert tds.cat_ids == jds.cat_ids
            assert tds.class_names == jds.class_names
            for r in tds.records:
                assert_same(tds.parse_annotations(r.img_id),
                            jds.parse_annotations(r.img_id))
                assert_same(tds.load_image(r), jds.load_image(r))


@pytest.mark.parametrize('device_normalize', [True, False])
def test_prepare_test_matches_jax(synth_dir, device_normalize):
    """Every image, plain and flipped, at the configured scale, at a half
    scale and at one beyond every canvas (the /size_divisor fallback)."""
    d, ann, _ = synth_dir
    jds, tds = _datasets(d, ann, False, device_normalize=device_normalize)
    for idx in range(len(tds)):
        for flip in (False, True):
            for scale in (None, (64, 48), (256, 192)):
                assert_same(tds.prepare_test(idx, flip=flip, img_scale=scale),
                            jds.prepare_test(idx, flip=flip, img_scale=scale),
                            f'{idx} flip {flip} scale {scale}')


@pytest.mark.parametrize('case', ['device_normalize', 'host_normalize',
                                  'always_flip', 'group_mode', 'crowd',
                                  'extra_augs'])
def test_prepare_train_matches_jax(synth_dir, case):
    d, ann, crowd = synth_dir
    kw = {'device_normalize': dict(flip_ratio=0.5),
          'host_normalize': dict(flip_ratio=0.5, device_normalize=False),
          'always_flip': dict(flip_ratio=1.0),
          'group_mode': dict(flip_ratio=0.5, group_mode=True),
          'crowd': dict(flip_ratio=0.5, max_ignore=4,
                        canvas_hw=((128, 160),), img_scale=(160, 120)),
          'extra_augs': dict(flip_ratio=0.5, photo_metric_distortion=True,
                             expand=True, random_crop=True)}[case]
    jds, tds = _datasets(d, crowd if case == 'crowd' else ann, True, **kw)
    for seed in range(2):
        for idx in range(len(tds)):
            assert_same(
                tds.prepare_train(idx, np.random.RandomState(seed * 31 + idx)),
                jds.prepare_train(idx, np.random.RandomState(seed * 31 + idx)),
                f'{case} {idx} seed {seed}')


def test_dataset_reads_png_without_cv2_as_jax_with_it(tmp_path, monkeypatch):
    """The synthetic set as PNGs, read and resized by the port's own code
    (cv2 hidden from image_io), gives the JAX package's samples (which read
    through cv2)."""
    d = str(tmp_path)
    ann = make_synth_coco(d, n_images=4)
    import json
    with open(ann) as f:
        coco = json.load(f)
    for im in coco['images']:
        png = im['file_name'].replace('.jpg', '.png')
        cv2.imwrite(os.path.join(d, png),
                    cv2.imread(os.path.join(d, im['file_name'])))
        im['file_name'] = png
    ann_png = os.path.join(d, 'png.json')
    with open(ann_png, 'w') as f:
        json.dump(coco, f)
    jte, _ = _datasets(d, ann_png, False, img_scale=(200, 150),
                       canvas_hw=((160, 224), (224, 160)))
    jtr, _ = _datasets(d, ann_png, True, flip_ratio=0.5)
    monkeypatch.setattr(image_io, 'cv2', None)
    _, tte = _datasets(d, ann_png, False, img_scale=(200, 150),
                       canvas_hw=((160, 224), (224, 160)))
    _, ttr = _datasets(d, ann_png, True, flip_ratio=0.5)
    for idx in range(len(tte)):
        assert_same(tte.prepare_test(idx), jte.prepare_test(idx))
        assert_same(ttr.prepare_train(idx, np.random.RandomState(idx)),
                    jtr.prepare_train(idx, np.random.RandomState(idx)))


def test_two_stage_inputs_raise_naming_item_6(synth_dir):
    """The mask families' inputs, which raised naming ROADMAP item 6 until
    they were ported: mask rasters (zero for annotations without polygons)
    and stuff maps (255 where an image has none) equal to the JAX
    dataset's, in training and at test (tests/test_torch_mask_families.py
    holds them on polygons and stuff PNGs); Fast R-CNN's proposal file
    loads (tests/test_torch_two_stage.py holds its samples against the JAX
    package's)."""
    d, ann, _ = synth_dir

    def port(**kw):
        return tdataset.DeepFashion2Dataset(TDataConfig(
            ann_file=ann, img_prefix=d, img_scale=(128, 96),
            canvas_hw=((96, 128), (128, 96)), **kw))
    path = os.path.join(d, 'proposals.pkl')
    with open(path, 'wb') as f:
        pickle.dump([np.zeros((3, 4), np.float32)] * 100, f)
    sample = port(proposal_file=path, num_proposals=8).prepare_test(0)
    assert sample['proposals'].shape == (8, 4)
    assert sample['proposals_valid'].tolist() == [True] * 3 + [False] * 5
    for kw, key in ((dict(with_mask=True), 'gt_masks'),
                    (dict(seg_prefix=d), 'gt_semantic_seg')):
        jds, tds = _datasets(d, ann, True, **kw)
        got = tds.prepare_train(0, np.random.RandomState(0))
        assert_same(got, jds.prepare_train(0, np.random.RandomState(0)))
        assert key in got
        assert not got['gt_masks'].any() if key == 'gt_masks' \
            else (got[key] == 255).all()


# ------------------------------------------------------------------- loader
@pytest.mark.parametrize('shuffle,drop_last', [(True, True), (True, False),
                                               (False, False)])
def test_grouped_batch_indices_match_jax(shuffle, drop_last):
    flags = np.random.RandomState(0).randint(0, 2, 23)
    for seed in (0, 7):
        for epoch in (0, 1, 5):
            for shards in (1, 2, 3):
                for bs in (1, 2, 4):
                    for shard in range(shards):
                        kw = dict(flags=flags, batch_size=bs, epoch=epoch,
                                  seed=seed, shuffle=shuffle,
                                  num_shards=shards, shard_id=shard,
                                  drop_last=drop_last)
                        assert_same(tloader.grouped_batch_indices(**kw),
                                    jloader.grouped_batch_indices(**kw))


def test_collate_matches_jax():
    rng = np.random.RandomState(0)
    samples = [{'image': rng.rand(4, 5, 3).astype(np.float32),
                'img_id': i, 'scale_factor': np.float32(0.5 * i),
                'flipped': np.bool_(i % 2)} for i in range(3)]
    assert_same(tloader.collate(samples), jloader.collate(samples))


@pytest.mark.parametrize('train', [True, False])
def test_loader_batches_match_jax(synth_dir, train):
    """Two epochs of batches, with 0 and 2 worker threads on the port's
    side, equal to the JAX loader's (0 workers)."""
    d, ann, _ = synth_dir
    jds, tds = _datasets(d, ann, train, flip_ratio=0.5)
    for epoch in (0, 1):
        jl = jloader.DataLoader(jds, 3, train=train, seed=4, num_workers=0)
        jl.set_epoch(epoch)
        want = list(jl)
        assert len(want) == len(jl)
        for workers in (0, 2):
            tl = tloader.DataLoader(tds, 3, train=train, seed=4,
                                    num_workers=workers, prefetch=1)
            tl.set_epoch(epoch)
            assert len(tl) == len(jl)
            got = list(tl)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert_same(g, w, f'epoch {epoch} workers {workers}')


@pytest.mark.parametrize('case', ['jpeg_without_cv2', 'corrupt_file'])
def test_threaded_loader_raises_a_sample_error(tmp_path, monkeypatch, case):
    """A sample that fails to load ends the threaded loader's iteration with
    its error: JPEGs that the NumPy reader does not decode (the error names
    cv2), or a file cv2 cannot decode. Nothing waits forever."""
    import threading
    d = str(tmp_path)
    ann = make_synth_coco(d, n_images=10)
    if case == 'jpeg_without_cv2':
        monkeypatch.setattr(image_io, 'cv2', None)
    else:
        with open(os.path.join(d, 'img_004.jpg'), 'wb') as f:
            f.write(b'not an image')
    _, tds = _datasets(d, ann, False)
    caught = []

    def iterate():
        try:
            list(tloader.DataLoader(tds, 3, train=False, num_workers=2,
                                    prefetch=1))
        except Exception as e:
            caught.append(e)
    t = threading.Thread(target=iterate, daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), 'the loader hung on a sample error'
    assert len(caught) == 1 and isinstance(caught[0],
                                           image_io.ImageDecodeError)
    if case == 'jpeg_without_cv2':
        assert 'cv2' in str(caught[0])
