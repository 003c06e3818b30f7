"""Data parallelism: one process a GPU under ``torchrun``.

The JAX package's distribution model (kgdet_tpu/parallel/train.py:1-10),
with "process" meaning one GPU: ``init_distributed`` joins the group that
torchrun describes, each process takes ``batch_size // world`` images of the
global batch (``shard_batch``; the loader strides whole batches over
processes), the parameters start equal on every process (``replicate``),
every count a loss is divided by is summed over processes first
(``global_sum``), and the train step sums the gradients over processes
before the optimizer clips their global norm (``all_reduce_grads``). The
gradients are then the single-program gradients of the global batch, and
every process holds the same parameters and optimizer state after every
step. ``init_distributed``, ``shard_batch`` and ``replicate`` are the
counterparts of ``make_mesh``, ``shard_batch`` and ``replicate``
(kgdet_tpu/parallel/train.py:256-294). Every helper is the identity outside
a process group.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def world():
    """(rank, world size) of torch.distributed, (0, 1) outside a process
    group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_sum(t):
    """``t`` summed over the processes, detached (``t`` itself outside a
    process group): every process gets the same sum."""
    if world()[1] == 1:
        return t
    import torch.distributed as dist
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def init_distributed(device=None, backend=None) -> torch.device:
    """Join the process group that torchrun describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this
    process's device: ``device``, by default (or given as ``cuda`` without
    an index) the card numbered LOCAL_RANK, an error where there is none.
    A card is made the current device before any model is built, so that
    ``torch.device('cuda')`` and the kernels' streams name it. The backend
    is nccl on a card and gloo on the CPU unless ``backend`` says otherwise
    (processes sharing one card take gloo). A process already in a group
    keeps it."""
    import torch.distributed as dist

    from kgdet_tpu_torch.api import resolve_device
    device = resolve_device(device)
    if device.type == 'cuda':
        if device.index is None:
            device = torch.device('cuda',
                                  int(os.environ.get('LOCAL_RANK', 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        missing = [v for v in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                               'MASTER_PORT') if v not in os.environ]
        if missing:
            raise RuntimeError(
                f'--distributed runs under torchrun (tools/dist_train.sh, '
                f'tools/dist_test.sh); {", ".join(missing)} not set')
        backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
        dist.init_process_group(
            backend, rank=int(os.environ['RANK']),
            world_size=int(os.environ['WORLD_SIZE']),
            device_id=device if backend == 'nccl' else None)
        # every process has joined, and the backend works, before any model
        # is built
        dist.barrier()
    return device


@contextlib.contextmanager
def process_group(device=None, backend=None):
    """``init_distributed(device, backend)`` for a with-block, as the CLIs'
    ``--distributed`` runs: yields this process's device, prints the
    backend and the world on process 0, and leaves the group at the end if
    the block joined it."""
    import torch.distributed as dist
    joined = not dist.is_initialized()
    device = init_distributed(device, backend)
    if dist.get_rank() == 0:
        print(f'[dist] process group: {dist.get_backend()}, '
              f'{dist.get_world_size()} process(es)', flush=True)
    try:
        yield device
    finally:
        if joined:
            dist.destroy_process_group()


def shard_batch(batch, rank: int, world_size: int):
    """Process ``rank``'s share of a global batch: the rank-th of
    ``world_size`` equal slices of every array's leading dimension; 0-d
    values (a sampler seed) as they are. Raises ValueError where a leading
    dimension does not divide, rather than hand every process the whole
    batch."""
    out = {}
    for k, v in batch.items():
        if np.ndim(v) == 0:
            out[k] = v
            continue
        n = len(v)
        if n % world_size:
            raise ValueError(
                f'shard_batch: leading dim {n} of {k!r} not divisible by '
                f'{world_size} processes')
        per = n // world_size
        out[k] = v[rank * per:(rank + 1) * per]
    return out


def _flat_groups(tensors):
    """``tensors`` grouped by (dtype, device), in their order."""
    groups = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups.values()


def _unflatten(flat, like):
    offset = 0
    for t in like:
        yield flat[offset:offset + t.numel()].view_as(t)
        offset += t.numel()


@torch.no_grad()
def replicate(tensors, src: int = 0):
    """Broadcast ``tensors`` (of a module: its parameters and buffers) from
    process ``src`` to every process, in place, one broadcast a dtype; a
    no-op outside a process group. The copies advance each tensor's
    version, which drops the frozen prefix's kept weights
    (ResNet.prefix_weights)."""
    if world()[1] == 1:
        return
    import torch.distributed as dist
    if isinstance(tensors, torch.nn.Module):
        tensors = [*tensors.parameters(), *tensors.buffers()]
    for group in _flat_groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        for t, v in zip(group, _unflatten(flat, group)):
            t.copy_(v)


@torch.no_grad()
def all_reduce_grads(params):
    """Sum the gradients of ``params`` over the processes, one all_reduce
    a dtype (each parameter's ``grad`` becomes a view of the sum). A
    parameter without a gradient contributes zeros, which is what the
    optimizer takes a missing gradient for. ``all_reduce_grads.bytes``
    counts the bytes reduced."""
    import torch.distributed as dist
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    for group in _flat_groups([p.grad for p in params]):
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        all_reduce_grads.bytes += flat.numel() * flat.element_size()
        for g, v in zip(group, _unflatten(flat, group)):
            g.copy_(v)


all_reduce_grads.bytes = 0
