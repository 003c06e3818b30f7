"""Pascal-VOC XML-style datasets: VOC 2007/2012 and WIDER Face.

Parity surface: reference mmdet/datasets/xml_style.py:14-82, voc.py:1-15,
wider_face.py:11-45 — the annotation list is a txt file of image ids; boxes
come from per-image XML files under <img_prefix>/Annotations; "difficult"
objects (and sub-min_size ones at train time) become ignore regions rather
than GTs. Fixed-shape sample preparation is inherited from the DeepFashion2
dataset; evaluation uses the VOC mean-AP protocol
(eval/mean_ap.py) instead of COCO.

Port of kgdet_tpu/data/xml_dataset.py: the XML is read with the standard
library, the images through data/image_io.py (the JPEGs of VOC and WIDER
need cv2, and image_io names it where it does not import).
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from kgdet_tpu_torch.config import DataConfig
from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset, ImageRecord

VOC_CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
               'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
               'train', 'tvmonitor')


class XMLDataset(DeepFashion2Dataset):
    """Map-style dataset over VOC-format XML annotations."""

    CLASSES = ()

    def __init__(self, cfg: DataConfig, train: bool = True,
                 min_size: Optional[int] = None):
        self.cfg = cfg
        self.train = train
        self.min_size = min_size
        self.num_keypoints = 1       # keypoint-free: zero (G, 1, 3) pads
        self.with_keypoints = False
        self.cat2label = {c: i + 1 for i, c in enumerate(self.CLASSES)}
        self.records = []
        with open(cfg.ann_file) as f:
            img_ids = [line.strip() for line in f if line.strip()]
        for img_id in img_ids:
            root = ET.parse(self._xml_path(img_id)).getroot()
            size = root.find('size')
            self.records.append(ImageRecord(
                img_id, self._filename(img_id, root),
                int(size.find('height').text),
                int(size.find('width').text)))
        self.flags = np.array(
            [1 if r.width / r.height > 1 else 0 for r in self.records],
            dtype=np.int64)

    def _xml_path(self, img_id):
        return os.path.join(self.cfg.img_prefix, 'Annotations',
                            f'{img_id}.xml')

    def _filename(self, img_id, root):
        return f'JPEGImages/{img_id}.jpg'

    def parse_annotations(self, img_id):
        """Boxes from the image's XML; difficult/too-small objects become
        ignore regions (xml_style.py:48-75, VOC -1 pixel convention)."""
        root = ET.parse(self._xml_path(img_id)).getroot()
        bboxes, labels, ignore = [], [], []
        for obj in root.findall('object'):
            name = obj.find('name').text
            if name not in self.cat2label:
                continue
            diff = obj.find('difficult')
            difficult = int(diff.text) if diff is not None else 0
            bb = obj.find('bndbox')
            box = [int(float(bb.find(t).text))
                   for t in ('xmin', 'ymin', 'xmax', 'ymax')]
            small = (self.min_size is not None and self.train
                     and (box[2] - box[0] < self.min_size
                          or box[3] - box[1] < self.min_size))
            if difficult or small:
                ignore.append(box)
            else:
                bboxes.append(box)
                labels.append(self.cat2label[name])
        ignore_arr = (np.asarray(ignore, np.float32) - 1 if ignore
                      else np.zeros((0, 4), np.float32))
        if not bboxes:
            return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int64),
                    np.zeros((0, 1, 3), np.float32), ignore_arr)
        n = len(bboxes)
        return (np.asarray(bboxes, np.float32) - 1,
                np.asarray(labels, np.int64),
                np.zeros((n, 1, 3), np.float32), ignore_arr)

    @property
    def class_names(self):
        return self.CLASSES


class VOCDataset(XMLDataset):
    CLASSES = VOC_CLASSES


class WIDERFaceDataset(XMLDataset):
    """WIDER Face in VOC layout: images live under per-event folders named
    by the XML's <folder> tag (wider_face.py:22-45)."""

    CLASSES = ('face',)

    def _filename(self, img_id, root):
        folder = root.find('folder').text
        return os.path.join(folder, f'{img_id}.jpg')
