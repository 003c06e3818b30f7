"""Training runner: epoch loop, logging, checkpointing, evaluation hook.

Port of kgdet_tpu/runner.py (the counterpart of mmcv's Runner and mmdet's
train_detector, reference mmdet/apis/train.py:137-221): the model, its
optimizer (parallel/train.py::SGDOptimizer) and the progress counters, one
train step per canvas bucket sharing that optimizer, checkpoints of the
port's own (utils/checkpoint.py), JSONL + text logs with the JAX package's
records, and a COCO evaluation after each epoch. Deterministic given (seed,
data); on the CPU a resumed run continues bit for bit.

In a process group (parallel/dist.py::init_distributed, one process a
GPU) each process drives one device: it takes ``batch_size // world``
images a step from its stride of the loader's batches, the parameters and
optimizer state are sent from process 0 after setup, process 0 alone
writes checkpoints and logs, and the evaluation is sharded, gathered and
scored on every process (eval_loop.py).
"""
from __future__ import annotations

import itertools
import json
import os
import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch

from kgdet_tpu_torch.api import build_model, resolve_device
from kgdet_tpu_torch.config import KGDetConfig
from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
from kgdet_tpu_torch.data.loader import DataLoader, grouped_batch_indices
from kgdet_tpu_torch.eval_loop import run_eval
from kgdet_tpu_torch.parallel.dist import replicate, world
from kgdet_tpu_torch.parallel.train import make_optimizer, make_train_step
from kgdet_tpu_torch.utils.checkpoint import CheckpointManager


class TrainLogger:
    """Rank-0 text + JSONL logging (parity: mmcv TextLoggerHook + JSON log)."""

    def __init__(self, work_dir: str, interval: int = 50, enabled=True):
        self.interval = interval
        self.enabled = enabled and world()[0] == 0
        self.buffer: deque = deque(maxlen=interval)
        self.jsonl_path = os.path.join(work_dir, 'train_log.jsonl')
        if self.enabled:
            os.makedirs(work_dir, exist_ok=True)

    def log_iter(self, epoch, it, total_iters, logs: Dict[str, Any], lr,
                 imgs_per_sec):
        # The logs stay on the device in the buffer and are copied to the
        # host once per interval (mmcv LogBuffer behavior): a float(v) per
        # key per step would wait for the device every step
        self.buffer.append(logs)
        if not self.enabled or (it + 1) % self.interval:
            return
        keys = list(self.buffer[0])
        host = torch.stack([torch.stack([b[k].float() for k in keys])
                            for b in self.buffer]).cpu().numpy()
        avg = {k: float(np.mean(host[:, j])) for j, k in enumerate(keys)}
        msg = (f'Epoch [{epoch + 1}][{it + 1}/{total_iters}] '
               f'lr: {lr:.5f}, loss: {avg["loss"]:.4f}, '
               f'img/s: {imgs_per_sec:.1f}')
        keys = [k for k in sorted(avg) if k.startswith('loss_')]
        msg += ''.join(f', {k}: {avg[k]:.4f}' for k in keys)
        msg += ''.join(f', {k}: {avg[k]:.2f}' for k in sorted(avg)
                       if k == 'acc' or k.startswith('acc_'))
        print(msg, flush=True)
        rec = dict(mode='train', epoch=epoch + 1, iter=it + 1, lr=float(lr),
                   imgs_per_sec=float(imgs_per_sec), **avg)
        with open(self.jsonl_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    def log_eval(self, epoch, stats: Dict[str, Dict[str, float]]):
        if not self.enabled:
            return
        for iou_type, s in stats.items():
            # mmdet-style copypaste line
            line = ' '.join(f'{s[k]:.4f}' for k in
                            ('AP', 'AP50', 'AP75') if k in s)
            print(f'Epoch [{epoch + 1}] {iou_type}_mAP_copypaste: {line}',
                  flush=True)
        rec = {'mode': 'val', 'epoch': epoch + 1}
        for iou_type, s in stats.items():
            rec.update({f'{iou_type}_{k}': float(v) for k, v in s.items()})
        with open(self.jsonl_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')


class Runner:
    """Owns model, optimizer and checkpoint state and the epoch loop, on
    ``device`` (None: the CUDA card, an error where there is none).
    ``n_devices`` is the number of processes (None: the process group's
    size, 1 outside one): a process drives one device, so any other count
    raises; start several processes with torchrun instead."""

    def __init__(self, cfg: KGDetConfig, work_dir: Optional[str] = None,
                 n_devices: Optional[int] = None, log_interval: int = 50,
                 val_dataset=None, device=None):
        if n_devices not in (None, world()[1]):
            raise ValueError(
                f'n_devices={n_devices} in a world of {world()[1]} '
                'process(es): a process drives one device; start one '
                'process a GPU with torchrun (tools/dist_train.sh)')
        self.cfg = cfg
        self.work_dir = work_dir or cfg.work_dir
        self.device = resolve_device(device)
        self.model = build_model(cfg, device='cpu')
        self.logger = TrainLogger(self.work_dir, log_interval)
        self.ckpt = CheckpointManager(
            os.path.join(self.work_dir, 'checkpoints'))
        self.val_dataset = val_dataset

        self.train_dataset = None
        self.train_loader = None
        self.steps_per_epoch = None
        self.optimizer = None
        self.schedule = None
        self.step = 0
        self.epoch = 0
        self._step_fns: Dict[tuple, Any] = {}

    # ------------------------------------------------------------ state init
    def setup(self, init_state_dict: Optional[Dict] = None,
              resume: bool = False, train_dataset=None):
        """Data, weights (seeded, or ``init_state_dict``: a state_dict of
        the model, e.g. ``state_dict_from_jax`` of the JAX package's
        variables), the optimizer, and with ``resume`` the newest
        checkpoint of ``work_dir``."""
        cfg = self.cfg
        if train_dataset is None:
            train_dataset = DeepFashion2Dataset(cfg.train_data, train=True)
        self.train_dataset = train_dataset
        rank, world_size = world()
        per_process = cfg.train_data.batch_size // world_size
        if per_process * world_size != cfg.train_data.batch_size:
            raise ValueError(
                f'train_data.batch_size {cfg.train_data.batch_size} not '
                f'divisible by {world_size} processes')
        self.train_loader = DataLoader(
            train_dataset, per_process, train=True, seed=cfg.seed,
            num_shards=world_size, shard_id=rank)
        # every process takes the same steps: an epoch's batches beyond a
        # multiple of the world are dropped (the count is the same every
        # epoch)
        self.steps_per_epoch = len(grouped_batch_indices(
            train_dataset.flags, per_process, 0, cfg.seed)) // world_size

        if init_state_dict is None:
            self.model.init_weights(cfg.seed)
        else:
            self.model.load_state_dict(init_state_dict, strict=True)
        self.model.to(self.device).train()
        self.optimizer, self.schedule = make_optimizer(
            cfg, self.model, self.steps_per_epoch)
        self._step_fns = {}

        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                self._load_state(self.ckpt.restore(latest))
                if self.logger.enabled:
                    print(f'[runner] resumed from step {latest} '
                          f'(epoch {self.epoch})', flush=True)
        # every process from process 0's weights and optimizer state
        opt = self.optimizer
        replicate([*self.model.parameters(), *self.model.buffers(),
                   *opt.momentum, *(opt.second_moment or [])])

    def _state_dict(self):
        return {
            'model': self.model.state_dict(),
            'optimizer': self.optimizer.state_dict(),
            'step': self.step,
            'epoch': self.epoch,
        }

    def _load_state(self, state):
        if state['optimizer']['step_count'] != state['step']:
            raise ValueError(
                f'checkpoint at step {state["step"]} holds an optimizer at '
                f'step {state["optimizer"]["step_count"]}')
        self.model.load_state_dict(state['model'], strict=True)
        self.optimizer.load_state_dict(state['optimizer'])
        self.step = int(state['step'])
        self.epoch = int(state['epoch'])

    # ------------------------------------------------------------ train step
    def _get_step_fn(self, canvas):
        if canvas not in self._step_fns:
            self._step_fns[canvas] = make_train_step(
                self.model, self.cfg, canvas, self.optimizer)
        return self._step_fns[canvas]

    def _to_device(self, batch):
        """A host batch on the device; on a CUDA device each array goes
        through pinned memory by a non-blocking copy."""
        cuda = self.device.type == 'cuda'
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.require(v, requirements='C'))
            if cuda:
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _device_prefetch(self, iterator, depth: int = 2):
        """Stage host batches on the device ``depth`` batches ahead of the
        step (the copies run ahead of the step's kernels in stream order,
        and the host does not wait for them)."""
        queue = deque()
        seed = self.cfg.seed * 100003 + self.step
        for batch in iterator:
            # per-step sampler seed (two-stage random subsampling)
            batch = dict(batch, seed=np.int32(seed % (2 ** 31)))
            seed += 1
            queue.append(self._to_device(batch))
            if len(queue) > depth:
                yield queue.popleft()
        while queue:
            yield queue.popleft()

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def train_epoch(self):
        self.model.train()
        self.train_loader.set_epoch(self.epoch)
        t_last = time.time()
        n_imgs = 0
        batches = itertools.islice(self.train_loader, self.steps_per_epoch)
        for it, batch in enumerate(self._device_prefetch(batches)):
            canvas = tuple(batch['image'].shape[1:3])
            logs = self._get_step_fn(canvas)(batch)
            self.step += 1
            n_imgs += batch['image'].shape[0]
            if (it + 1) % self.logger.interval == 0:
                self._sync()
                dt = time.time() - t_last
                ips = n_imgs * world()[1] / max(dt, 1e-9)
                lr = float(self.schedule(self.step - 1))
                self.logger.log_iter(self.epoch, it, self.steps_per_epoch,
                                     logs, lr, ips)
                t_last = time.time()
                n_imgs = 0
            else:
                self.logger.log_iter(self.epoch, it, self.steps_per_epoch,
                                     logs, 0.0, 0.0)
        self.epoch += 1

    def save_checkpoint(self, wait: bool = False):
        """Process 0 writes the step; in a process group every process
        then waits for it, so that a resume finds the step complete."""
        if world()[0] == 0:
            self.ckpt.save(self.step, self._state_dict(), wait=wait)
        if world()[1] > 1:
            import torch.distributed as dist
            dist.barrier()

    def evaluate(self, verbose: bool = True):
        if self.val_dataset is None:
            self.val_dataset = DeepFashion2Dataset(
                self.cfg.val_data, train=False)
        self.model.eval()
        try:
            stats, _ = run_eval(
                self.model, self.cfg, self.val_dataset,
                out_prefix=os.path.join(self.work_dir,
                                        f'eval_epoch{self.epoch}'),
                verbose=verbose)
        finally:
            self.model.train()
        return stats

    def run(self, validate: bool = False, max_epochs: Optional[int] = None):
        total = max_epochs or self.cfg.optim.total_epochs
        while self.epoch < total:
            self.train_epoch()
            self.save_checkpoint()
            if validate:
                stats = self.evaluate()
                self.logger.log_eval(self.epoch - 1, stats)
        self.ckpt.close()
