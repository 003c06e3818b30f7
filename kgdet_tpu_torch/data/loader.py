"""Batched, prefetching data loader with aspect-ratio-grouped sampling.

The port's own copy of kgdet_tpu/data/loader.py, NumPy and the stdlib only.
It replaces the reference's torch DataLoader + GroupSampler /
DistributedGroupSampler (mmdet/datasets/loader/build_loader.py:17-47,
sampler.py:37-141): batches draw from one aspect-ratio group so every image in
the batch shares a canvas shape (one predict function per canvas); shuffling
is epoch-seeded and deterministic, with the JAX package's per-sample seed, so
the batch order and every sample equal its loader's; sharding is
process-strided; a background thread pool decodes and transforms images
ahead of the step. The worker threads do host NumPy work only: batches stay
NumPy arrays, and the caller moves them to the device. A sample that fails
to load raises its error in the iterating thread (the JAX package's
producer thread dies with it, and its consumer waits on the queue).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np


def grouped_batch_indices(flags: np.ndarray, batch_size: int, epoch: int,
                          seed: int = 0, shuffle: bool = True,
                          num_shards: int = 1, shard_id: int = 0,
                          drop_last: bool = True) -> List[np.ndarray]:
    """Deterministic group-homogeneous batch index lists for one epoch.

    Each group's indices are shuffled (epoch-seeded), padded by wrap-around to
    a multiple of (batch_size * num_shards), split into batches, and the batch
    list itself is shuffled; finally batches are strided over shards.
    """
    rng = np.random.RandomState(seed + epoch)
    batches = []
    step = batch_size
    for g in np.unique(flags):
        idx = np.where(flags == g)[0]
        if shuffle:
            idx = idx[rng.permutation(len(idx))]
        total = len(idx)
        target = -(-total // step) * step
        if target > total:
            if drop_last and total >= step:
                idx = idx[:total - total % step]
            else:
                extra = rng.choice(idx, target - total) if shuffle \
                    else idx[:target - total]
                idx = np.concatenate([idx, extra])
        batches.extend(np.split(idx, len(idx) // step))
    if shuffle:
        batches = [batches[i] for i in rng.permutation(len(batches))]
    return batches[shard_id::num_shards]


def collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals) if np.ndim(vals[0]) else np.asarray(vals)
    return out


class DataLoader:
    """Iterates group-homogeneous batches with threaded prefetch.

    dataset must expose __len__, flags, prepare_train(idx, rng) /
    prepare_test(idx).
    """

    def __init__(self, dataset, batch_size: int, train: bool = True,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 4,
                 num_shards: int = 1, shard_id: int = 0,
                 shuffle: Optional[bool] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = train if shuffle is None else shuffle
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_batches(self) -> List[np.ndarray]:
        flags = self.dataset.flags if self.train else \
            np.asarray(self.dataset.flags)
        return grouped_batch_indices(
            flags, self.batch_size, self.epoch, self.seed, self.shuffle,
            self.num_shards, self.shard_id, drop_last=self.train)

    def __len__(self):
        return len(self._epoch_batches())

    def _load_sample(self, idx: int) -> Dict:
        if self.train:
            # per-sample deterministic rng: (seed, epoch, index)
            rng = np.random.RandomState(
                (self.seed * 1000003 + self.epoch * 9176 + int(idx))
                % (2 ** 31))
            return self.dataset.prepare_train(int(idx), rng)
        return self.dataset.prepare_test(int(idx))

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._epoch_batches()
        if self.num_workers <= 0:
            for batch_idx in batches:
                yield collate([self._load_sample(i) for i in batch_idx])
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = []
                    for batch_idx in batches:
                        pending.append(
                            [pool.submit(self._load_sample, i)
                             for i in batch_idx])
                        # keep a bounded window of in-flight batches
                        while len(pending) > self.prefetch:
                            if stop.is_set():
                                return
                            q.put(collate(
                                [f.result() for f in pending.pop(0)]))
                    for futs in pending:
                        if stop.is_set():
                            return
                        q.put(collate([f.result() for f in futs]))
            except Exception as e:
                # a sample that fails to load (a missing or undecodable
                # image) ends the iteration with its error in the caller
                q.put(e)
                return
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
