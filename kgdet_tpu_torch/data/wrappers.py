"""Dataset wrappers: Concat and Repeat (parity: reference
mmdet/datasets/dataset_wrappers.py ConcatDataset / RepeatDataset).

Port of kgdet_tpu/data/wrappers.py. Both expose the DataLoader protocol
(__len__, flags, prepare_train, prepare_test) by delegating to the wrapped
dataset(s); the grouped loader reads the combined aspect ``flags``.
"""
from __future__ import annotations

import bisect
from typing import Sequence

import numpy as np


class ConcatDataset:
    """Concatenation of several datasets with combined aspect flags."""

    def __init__(self, datasets: Sequence):
        assert datasets
        self.datasets = list(datasets)
        self.cumulative = np.cumsum([len(d) for d in self.datasets]).tolist()
        self.flags = np.concatenate([np.asarray(d.flags)
                                     for d in self.datasets])

    def __len__(self):
        return self.cumulative[-1]

    def _locate(self, idx: int):
        if idx < 0 or idx >= len(self):
            raise IndexError(idx)
        ds_idx = bisect.bisect_right(self.cumulative, idx)
        base = 0 if ds_idx == 0 else self.cumulative[ds_idx - 1]
        return self.datasets[ds_idx], idx - base

    def prepare_train(self, idx, rng):
        ds, local = self._locate(idx)
        return ds.prepare_train(local, rng)

    def prepare_test(self, idx):
        ds, local = self._locate(idx)
        return ds.prepare_test(local)

    @property
    def cat_ids(self):
        return self.datasets[0].cat_ids

    @property
    def coco(self):
        return self.datasets[0].coco


class RepeatDataset:
    """Virtually repeat a dataset N times (epoch-stretching for small sets)."""

    def __init__(self, dataset, times: int):
        assert times >= 1
        self.dataset = dataset
        self.times = times
        self.flags = np.tile(np.asarray(dataset.flags), times)

    def __len__(self):
        return self.times * len(self.dataset)

    def prepare_train(self, idx, rng):
        return self.dataset.prepare_train(idx % len(self.dataset), rng)

    def prepare_test(self, idx):
        return self.dataset.prepare_test(idx % len(self.dataset))

    @property
    def cat_ids(self):
        return self.dataset.cat_ids

    @property
    def coco(self):
        return self.dataset.coco
