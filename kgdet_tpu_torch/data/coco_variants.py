"""COCO-format dataset variants: Cityscapes and DeepFashion (3-class).

Parity surface: reference mmdet/datasets/cityscapes.py (CocoDataset with
the 8 instance classes) and deepfashion.py (3 garment super-classes with
8 keypoints and per-class flip pairs). Both reuse the fixed-shape
DeepFashion2Dataset machinery; only class metadata and flip pairing
differ. Port of kgdet_tpu/data/coco_variants.py.
"""
from __future__ import annotations

import numpy as np

from kgdet_tpu_torch.config import DataConfig
from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset


class CityscapesDataset(DeepFashion2Dataset):
    """Cityscapes instance detection in COCO format (cityscapes.py:6-9)."""

    CLASSES = ('person', 'rider', 'car', 'truck', 'bus', 'train',
               'motorcycle', 'bicycle')

    def __init__(self, cfg: DataConfig, train: bool = True, **kw):
        super().__init__(cfg, train=train, **kw)
        self.num_keypoints = 1
        self.with_keypoints = False

    @property
    def class_names(self):
        return self.CLASSES


class DeepFashionDataset(DeepFashion2Dataset):
    """DeepFashion 3 super-classes with an 8-keypoint layout and
    per-class flip pairs (deepfashion.py:8-19)."""

    CLASSES = ('Upper', 'Lower', 'Whole')
    # per 1-based class: (a, b) keypoint index swaps under horizontal flip
    FLIP_PAIRS = {1: ((0, 1), (2, 3), (6, 7)),
                  2: ((4, 5), (6, 7)),
                  3: ((0, 1), (2, 3), (4, 5), (6, 7))}

    def __init__(self, cfg: DataConfig, train: bool = True, **kw):
        super().__init__(cfg, train=train, **kw)
        self.num_keypoints = 8

    def flip_kpts(self, kpts, labels, img_w):
        out = kpts.copy()
        vis = out[..., 2] > 0
        out[..., 0] = np.where(vis, img_w - out[..., 0] - 1, out[..., 0])
        for i in range(out.shape[0]):
            for a, b in self.FLIP_PAIRS[int(labels[i])]:
                out[i, [a, b]] = out[i, [b, a]]
        return out

    @property
    def class_names(self):
        return self.CLASSES
