"""Minimal COCO-style annotation index (pure NumPy/stdlib, no pycocotools).

Provides the subset of the COCO API that detection/keypoint evaluation and the
data pipeline need: image/annotation/category indexing and building a result
index from a list of detection dicts.

Parity reference: the DeepFashion2 API's PythonAPI/pycocotools/coco.py
(behavioral equivalent for the ann-index and loadRes paths).

The port's own copy of kgdet_tpu/eval/coco.py, NumPy and the stdlib;
segmentation results go through the port's RLE code
(kgdet_tpu_torch/native/).
"""
from __future__ import annotations

import copy
import json
from collections import defaultdict


class CocoIndex:
    """Index over a COCO-format annotation dict.

    Accepts a path to a JSON file or an already-parsed dict with keys
    ``images``, ``annotations``, ``categories``.
    """

    def __init__(self, source=None):
        self.dataset = {}
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.img_to_anns = defaultdict(list)
        self.cat_to_imgs = defaultdict(list)
        if source is not None:
            if isinstance(source, (str,)):
                with open(source) as f:
                    self.dataset = json.load(f)
            elif isinstance(source, dict):
                self.dataset = source
            else:
                raise TypeError(f'unsupported source type: {type(source)}')
            self._build_index()

    def _build_index(self):
        anns, imgs, cats = {}, {}, {}
        img_to_anns = defaultdict(list)
        cat_to_imgs = defaultdict(list)
        for ann in self.dataset.get('annotations', []):
            img_to_anns[ann['image_id']].append(ann)
            anns[ann['id']] = ann
        for img in self.dataset.get('images', []):
            imgs[img['id']] = img
        for cat in self.dataset.get('categories', []):
            cats[cat['id']] = cat
        for ann in self.dataset.get('annotations', []):
            cat_to_imgs[ann['category_id']].append(ann['image_id'])
        self.anns = anns
        self.imgs = imgs
        self.cats = cats
        self.img_to_anns = img_to_anns
        self.cat_to_imgs = cat_to_imgs

    @property
    def img_ids(self):
        return list(self.imgs.keys())

    @property
    def cat_ids(self):
        return sorted(self.cats.keys())

    def anns_for_img(self, img_id):
        return self.img_to_anns.get(img_id, [])

    def load_results(self, results):
        """Build a result index sharing this GT's images.

        ``results`` is a list of dicts with ``image_id``, ``category_id``,
        ``score`` and one of ``bbox`` (xywh) / ``keypoints`` (flat x,y,v), or a
        path to such a JSON file.
        """
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        res = CocoIndex()
        res.dataset = {
            'images': list(self.dataset.get('images', [])),
            'categories': copy.deepcopy(self.dataset.get('categories', [])),
            'annotations': [],
        }
        anns = copy.deepcopy(results)
        for i, ann in enumerate(anns):
            ann['id'] = i + 1
            if 'segmentation' in ann and 'bbox' not in ann:
                from kgdet_tpu_torch.eval.cocoeval import ann_to_rle
                size = (ann['segmentation'].get('size')
                        if isinstance(ann['segmentation'], dict) else None)
                if size is None:
                    img = self.imgs[ann['image_id']]
                    size = (img['height'], img['width'])
                rle = ann_to_rle(ann, size[0], size[1])
                ann.setdefault('area', float(rle.area()))
                ann.setdefault('bbox', rle.to_bbox().tolist())
            elif 'bbox' in ann:
                x, y, w, h = ann['bbox']
                ann.setdefault('area', w * h)
                ann.setdefault('segmentation', [[x, y, x, y + h, x + w, y + h, x + w, y]])
            elif 'keypoints' in ann:
                kps = ann['keypoints']
                xs = kps[0::3]
                ys = kps[1::3]
                x0, x1 = min(xs), max(xs)
                y0, y1 = min(ys), max(ys)
                ann.setdefault('area', (x1 - x0) * (y1 - y0))
                ann.setdefault('bbox', [x0, y0, x1 - x0, y1 - y0])
            ann.setdefault('iscrowd', 0)
        res.dataset['annotations'] = anns
        res._build_index()
        return res
