"""The dataset variants and wrappers of the port (kgdet_tpu_torch:
data/wrappers.py, data/xml_dataset.py, data/coco_variants.py) against
kgdet_tpu on the same files, written into tmp_path as
tests/test_xml_datasets.py and tests/test_wrappers.py write them: records,
parsed annotations, samples, loader batches and the evaluation index,
array for array with the same dtypes."""
import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip('cv2')

from kgdet_tpu.data import coco_variants as jvariants
from kgdet_tpu.data import loader as jloader
from kgdet_tpu.data import wrappers as jwrappers
from kgdet_tpu.data import xml_dataset as jxml
from kgdet_tpu.data.dataset import DeepFashion2Dataset as JDataset
from kgdet_tpu.eval.mean_ap import eval_voc_results as jeval_voc
from kgdet_tpu_torch.data import coco_variants as tvariants
from kgdet_tpu_torch.data import loader as tloader
from kgdet_tpu_torch.data import wrappers as twrappers
from kgdet_tpu_torch.data import xml_dataset as txml
from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset as TDataset
from kgdet_tpu_torch.eval.mean_ap import eval_voc_results as teval_voc
from tests.test_data import make_synth_coco
from tests.test_torch_data import assert_same, both
from tests.test_xml_datasets import _write_xml, make_voc_tree


def assert_same_records(jds, tds):
    assert len(jds) == len(tds)
    assert [vars(r) for r in jds.records] == [vars(r) for r in tds.records]
    assert_same(jds.flags, tds.flags, 'flags')


def assert_same_samples(jds, tds, train, n=None):
    """prepare_train (on equal RandomStates) or prepare_test, sample by
    sample."""
    for i in range(len(jds) if n is None else n):
        if train:
            a = jds.prepare_train(i, np.random.RandomState(i))
            b = tds.prepare_train(i, np.random.RandomState(i))
        else:
            a, b = jds.prepare_test(i), tds.prepare_test(i)
        assert_same(a, b, f'sample {i}')


def assert_same_batches(jds, tds, batch_size, train):
    got = list(tloader.DataLoader(tds, batch_size, train=train,
                                  num_workers=0))
    want = list(jloader.DataLoader(jds, batch_size, train=train,
                                   num_workers=0))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert_same(g, w, 'batch')


@pytest.fixture(scope='module')
def voc(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('voc'))
    ann_file = make_voc_tree(d)
    # one image more, with a small box that min_size moves to ignore
    _write_xml(os.path.join(d, 'Annotations', '000004.xml'), 120, 160,
               [('dog', (10, 10, 15, 15), 0), ('cat', (20, 20, 80, 80), 0),
                ('unknown', (5, 5, 50, 50), 0)])
    cv2.imwrite(os.path.join(d, 'JPEGImages', '000004.jpg'),
                np.random.RandomState(4).randint(0, 255, (160, 120, 3),
                                                 np.uint8))
    with open(ann_file, 'a') as f:
        f.write('\n000004\n')
    return both(ann_file=ann_file, img_prefix=d, img_scale=(160, 120),
                max_gts=8, max_ignore=4, flip_ratio=0.5, batch_size=2,
                canvas_hw=((128, 160), (160, 128)))


@pytest.mark.parametrize('train', [True, False])
def test_voc_records_samples_batches_and_eval(voc, train):
    jcfg, tcfg = voc
    jds = jxml.VOCDataset(jcfg, train=train, min_size=8)
    tds = txml.VOCDataset(tcfg, train=train, min_size=8)
    assert txml.VOC_CLASSES == jxml.VOC_CLASSES
    assert tds.class_names == jds.class_names
    assert tds.cat2label == jds.cat2label
    assert_same_records(jds, tds)
    for r in jds.records:
        assert_same(tds.parse_annotations(r.img_id),
                    jds.parse_annotations(r.img_id), r.img_id)
    assert_same_samples(jds, tds, train)
    assert_same_batches(jds, tds, 2, train)
    # the VOC mean-AP protocol on jittered ground truth
    rng = np.random.RandomState(0)
    results = {}
    for r in jds.records:
        b, l, _, _ = jds.parse_annotations(r.img_id)
        dets = np.concatenate([b + rng.uniform(-4, 4, b.shape),
                               rng.rand(len(b), 1)], 1).astype(np.float32)
        results[r.img_id] = (dets, l - 1, np.zeros((len(b), 3)))
    for mode in ('area', '11points'):
        got, want = teval_voc(results, tds, mode=mode), \
            jeval_voc(results, jds, mode=mode)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12)


def test_widerface_records_and_samples(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, 'Annotations'))
    os.makedirs(os.path.join(d, '0--Parade'))
    rng = np.random.RandomState(1)
    ids = ['img1', 'img2']
    for i, img_id in enumerate(ids):
        cv2.imwrite(os.path.join(d, '0--Parade', f'{img_id}.jpg'),
                    rng.randint(0, 255, (100, 150 - 40 * i, 3), np.uint8))
        _write_xml(os.path.join(d, 'Annotations', f'{img_id}.xml'),
                   150 - 40 * i, 100,
                   [('face', (10, 10, 50, 50), 0),
                    ('face', (60, 20, 90, 70), 1)], folder='0--Parade')
    ann_file = os.path.join(d, 'val.txt')
    with open(ann_file, 'w') as f:
        f.write('\n'.join(ids))
    jcfg, tcfg = both(ann_file=ann_file, img_prefix=d, img_scale=(160, 120),
                      max_gts=4, canvas_hw=((128, 160), (160, 128)))
    for train in (True, False):
        jds = jxml.WIDERFaceDataset(jcfg, train=train)
        tds = txml.WIDERFaceDataset(tcfg, train=train)
        assert tds.records[0].filename == os.path.join('0--Parade',
                                                       'img1.jpg')
        assert_same_records(jds, tds)
        assert_same_samples(jds, tds, train)


@pytest.fixture(scope='module')
def variants_set(tmp_path_factory):
    """tests/test_wrappers.py's image with 8 keypoints on class 1, and two
    more images, one per remaining class."""
    d = str(tmp_path_factory.mktemp('variants'))
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i, (w, h) in enumerate(((150, 100), (100, 150), (150, 100))):
        cv2.imwrite(os.path.join(d, f'i{i}.jpg'),
                    rng.randint(0, 255, (h, w, 3), np.uint8))
        images.append({'id': i + 1, 'file_name': f'i{i}.jpg', 'width': w,
                       'height': h})
        kpts = np.zeros((8, 3), np.float32)
        kpts[:, 0] = np.arange(8) * 8 + 12
        kpts[:, 1] = 30 + 5 * i
        kpts[:, 2] = rng.randint(0, 3, 8)
        anns.append({'id': i + 1, 'image_id': i + 1, 'category_id': i + 1,
                     'bbox': [10.0, 10.0, 80.0, 60.0], 'area': 4800.0,
                     'iscrowd': 0, 'keypoints': kpts.reshape(-1).tolist()})
    ann = os.path.join(d, 'ann.json')
    with open(ann, 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': [{'id': c, 'name': f'c{c}'}
                                  for c in (1, 2, 3)]}, f)
    return both(ann_file=ann, img_prefix=d, img_scale=(150, 100), max_gts=4,
                flip_ratio=1.0, batch_size=1,
                canvas_hw=((96, 160), (160, 96)))


@pytest.mark.parametrize('name', ['CityscapesDataset', 'DeepFashionDataset'])
def test_coco_variant_records_samples_and_index(variants_set, name):
    jcfg, tcfg = variants_set
    for train in (True, False):
        jds = getattr(jvariants, name)(jcfg, train=train)
        tds = getattr(tvariants, name)(tcfg, train=train)
        assert tds.class_names == jds.class_names
        assert (tds.num_keypoints, tds.with_keypoints) == \
            (jds.num_keypoints, jds.with_keypoints)
        assert_same_records(jds, tds)
        assert tds.cat_ids == jds.cat_ids
        assert tds.coco.img_ids == jds.coco.img_ids
        assert_same_samples(jds, tds, train)
        assert_same_batches(jds, tds, 1, train)
    if name == 'DeepFashionDataset':
        kpts = np.random.RandomState(2).rand(3, 8, 3).astype(np.float32)
        labels = np.array([1, 2, 3])
        assert_same(tds.flip_kpts(kpts, labels, 150),
                    jds.flip_kpts(kpts, labels, 150))


@pytest.fixture(scope='module')
def coco_pair(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('wrap_coco'))
    ann = make_synth_coco(d, n_images=4)
    jcfg, tcfg = both(ann_file=ann, img_prefix=d, img_scale=(128, 96),
                      max_gts=8, canvas_hw=((96, 128), (128, 96)))
    return JDataset(jcfg, train=True), TDataset(tcfg, train=True)


def test_repeat_dataset(coco_pair):
    jds, tds = coco_pair
    jr, tr = jwrappers.RepeatDataset(jds, 3), twrappers.RepeatDataset(tds, 3)
    assert len(tr) == len(jr) == 3 * len(tds)
    assert_same(tr.flags, jr.flags, 'flags')
    assert tr.cat_ids == jr.cat_ids and tr.coco is tds.coco
    for i in (1, 1 + len(tds), len(tr) - 1):
        assert_same(tr.prepare_train(i, np.random.RandomState(i)),
                    jr.prepare_train(i, np.random.RandomState(i)), str(i))
        assert_same(tr.prepare_test(i), jr.prepare_test(i), str(i))
    assert_same_batches(jr, tr, 2, train=True)


def test_concat_dataset_and_the_grouped_loader_over_it(coco_pair,
                                                       tmp_path):
    jds, tds = coco_pair
    d = str(tmp_path)
    ann = make_synth_coco(d, n_images=3, seed=1, landscape_only=True)
    jcfg, tcfg = both(ann_file=ann, img_prefix=d, img_scale=(128, 96),
                      max_gts=8, canvas_hw=((96, 128), (128, 96)))
    jv, tv = JDataset(jcfg, train=True), TDataset(tcfg, train=True)
    jc = jwrappers.ConcatDataset([jds, jv, jds])
    tc = twrappers.ConcatDataset([tds, tv, tds])
    assert len(tc) == len(jc) == 2 * len(tds) + len(tv)
    assert tc.cumulative == jc.cumulative
    assert_same(tc.flags, jc.flags, 'flags')
    assert tc.cat_ids == jc.cat_ids and tc.coco is tds.coco
    for i in range(len(tc)):
        assert_same(tc.prepare_test(i), jc.prepare_test(i), str(i))
    for i in (0, len(tds), len(tc) - 1):
        assert_same(tc.prepare_train(i, np.random.RandomState(i)),
                    jc.prepare_train(i, np.random.RandomState(i)), str(i))
    with pytest.raises(IndexError):
        tc._locate(len(tc))
    # the grouped loader reads the combined flags: both aspect groups, the
    # same batches as the JAX loader's, over two epochs
    for epoch in range(2):
        tl = tloader.DataLoader(tc, 2, train=True, num_workers=0)
        jl = jloader.DataLoader(jc, 2, train=True, num_workers=0)
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        got, want = list(tl), list(jl)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert_same(g, w, f'epoch {epoch}')
