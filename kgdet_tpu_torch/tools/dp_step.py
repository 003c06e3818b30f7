"""One data-parallel train step and sharded inference, for holding several
processes against one.

  torchrun --nproc_per_node=N -m kgdet_tpu_torch.tools.dp_step CONFIG \
      --state STATE.pt --batch BATCH.npz --out DIR \
      [--dtype float32 bfloat16] [--infer-config CONFIG2] \
      [--device cuda:0] [--backend gloo]

Every process joins the group (parallel/dist.py::init_distributed), loads
the model's state_dict (STATE.pt, ``torch.save``) and the global batch
(BATCH.npz), and for each ``--dtype`` takes one train step on its share of
the batch (``shard_batch``) from those weights. With ``--infer-config`` it
then infers that config's validation set in f32 from the same weights, in
its stride of the batches, and gathers the detections
(eval_loop.py::infer_dataset). Each process writes DIR/rank<r>.pt: per
dtype the logs, the gradients as the optimizer took them, the parameters
and optimizer momentum after the step, the kernels' launches, the
step's ms (on a card after a step that is undone, so that the timed step
finds cuDNN's plans and the kernels loaded), the names of the program's
spans the step recorded and the gradient bytes it all-reduced
(``all_reduce_grads.bytes``); and the detections, the
launches and the batches of inference. TF32 is off: a float32 step
computes in f32.

``take_step`` and ``infer`` are its parts for a caller in one process,
which is the reference the processes are held to.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def kernel_launches():
    """The port's kernel wrappers' launch counts, by kernel name."""
    from kgdet_tpu_torch.ops.deform_kernels import (
        deform_conv_fused, deform_sample_bwd, deform_sample_cols,
        deform_sample_split)
    from kgdet_tpu_torch.ops.bn_epilogue import bn_epilogue
    from kgdet_tpu_torch.ops.nms import greedy_nms
    from kgdet_tpu_torch.ops.resblock import fused_bottleneck
    from kgdet_tpu_torch.ops.stem_kernels import frozen_bottleneck, stem_pool
    return {'deform_fused': deform_conv_fused.launches,
            'deform_sample_split': deform_sample_split.launches,
            'deform_sample_bwd': deform_sample_bwd.launches,
            'stem_pool': stem_pool.launches,
            'frozen_bottleneck': frozen_bottleneck.launches,
            'deform_sample_cols': deform_sample_cols.launches,
            'fused_bottleneck': fused_bottleneck.launches,
            'greedy_nms': greedy_nms.launches,
            'bn_epilogue': bn_epilogue.launches}


def _since(before):
    return {k: v - before[k] for k, v in kernel_launches().items()}


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def load_model(cfg, state, device, dtype):
    """The config's detector with ``state`` on ``device``, computing in
    ``dtype``, its weights those of process 0."""
    from kgdet_tpu_torch.api import build_model
    from kgdet_tpu_torch.parallel.dist import replicate
    model = build_model(cfg, device='cpu')
    model.load_state_dict(state, strict=True)
    model.to(device)
    model.dtype = dtype
    replicate(model)
    return model


def take_step(cfg, state, batch, device, dtype, steps_per_epoch=1000):
    """One train step of this process on its share of the global
    ``batch`` (numpy arrays) from the weights ``state``. Returns logs,
    gradients, parameters and momentum after the step (on the CPU),
    launches and ms."""
    from kgdet_tpu_torch.parallel.dist import all_reduce_grads, \
        shard_batch, world
    from kgdet_tpu_torch.parallel.train import make_optimizer, make_train_step
    from kgdet_tpu_torch.utils import trace
    device = torch.device(device)
    rank, world_size = world()
    share = shard_batch(batch, rank, world_size)
    feed = {k: torch.as_tensor(v).to(device) for k, v in share.items()
            if np.ndim(v)}
    model = load_model(cfg, state, device, dtype).train()
    canvas = tuple(batch['image'].shape[1:3])
    for warm in (True, False) if device.type == 'cuda' else (False,):
        optimizer, _ = make_optimizer(cfg, model, steps_per_epoch)
        step = make_train_step(model, cfg, canvas, optimizer)
        _sync(device)
        before, t0 = kernel_launches(), time.perf_counter()
        reduced = all_reduce_grads.bytes
        with trace.recording() as rec:
            logs = step(feed)
        _sync(device)
        ms = 1e3 * (time.perf_counter() - t0)
        if warm:
            model.load_state_dict(state)
    launches = _since(before)
    momentum = dict(zip(optimizer.names, optimizer.momentum))
    out = {'logs': {k: v.item() for k, v in logs.items()},
           'grads': {n: p.grad.detach().cpu().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None},
           'params': {n: p.detach().cpu().clone()
                      for n, p in model.named_parameters()},
           'momentum': {n: m.cpu().clone() for n, m in momentum.items()},
           'launches': launches, 'ms': ms,
           'spans': [r.name for r in rec.records],
           'reduced_bytes': all_reduce_grads.bytes - reduced}
    return out


def infer(cfg, state, device, batch_size=None):
    """The detections of the config's validation set in f32 from the
    weights ``state``: this process's stride of the batches, gathered
    from every process. Returns results, launches and the batches this
    process inferred."""
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.eval_loop import infer_dataset
    device = torch.device(device)
    model = load_model(cfg, state, device, torch.float32).eval()
    dataset = DeepFashion2Dataset(cfg.val_data, train=False)
    timings = {}
    before = kernel_launches()
    results, _ = infer_dataset(model, cfg, dataset, batch_size=batch_size,
                               verbose=False, timings=timings)
    return {'results': results, 'launches': _since(before),
            'batches': timings['batches'], 'images': timings['images']}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('config')
    p.add_argument('--state', required=True)
    p.add_argument('--batch', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--dtype', nargs='+', default=['float32'],
                   choices=['float32', 'bfloat16'])
    p.add_argument('--infer-config', default=None)
    p.add_argument('--device', default=None)
    p.add_argument('--backend', default=None)
    args = p.parse_args(argv)

    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.parallel.dist import process_group, world
    # f32 is f32 here, as in the process it is held against: cuDNN's
    # convolutions would otherwise round their inputs to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with process_group(args.device, args.backend) as device:
        cfg = load_config(args.config)
        state = torch.load(args.state, map_location='cpu', weights_only=True)
        with np.load(args.batch) as f:
            batch = {k: f[k] for k in f.files}
        out = {'world': world()[1], 'device': str(device), 'steps': {
            name: take_step(cfg, state, batch, device, getattr(torch, name))
            for name in args.dtype}}
        if args.infer_config:
            out['infer'] = infer(load_config(args.infer_config), state,
                                 device)
        os.makedirs(args.out, exist_ok=True)
        torch.save(out, os.path.join(args.out, f'rank{world()[0]}.pt'))


if __name__ == '__main__':
    main()
