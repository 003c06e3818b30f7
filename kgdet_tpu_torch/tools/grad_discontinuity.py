#!/usr/bin/env python3
"""How far a ReLU that changes sides moves the port's training gradients.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 kgdet_tpu_torch/tools/grad_discontinuity.py [samples]

Builds the full-width model of chip_smoke.py through init_trainer and, over
``samples`` (default 150) seeded batches and weight states (a bf16 train
step after every fourth sample), takes the f32 loss and gradients twice on
the same batch: with the deformable stages on their kernels (K2, K3) and on
the plain versions, the frozen prefix on its kernels both times. The two
runs differ by rounding order only, yet now and then a pre-activation of
the ReLU behind the deformable convs is within rounding of zero and falls
on different sides: the loss stays, one weight gradient moves. Prints each
sample that moved by more than 1e-4 of a gradient's scale, then over all
samples the quantiles of the worst difference, and over the parameter
groups that chip_smoke.py compares the worst difference and the largest
share of their elements beyond 1e-3 of their parameter's scale: the numbers
behind chip_smoke.py's MODEL_GRAD_REL and MODEL_FLIP_SHARE. Before that it
runs the frozen prefix (K4, K5) 100 times on one batch, in f32 and bf16,
and counts the runs whose output is not bit-equal to the first: the prefix
has to be reproducible for the comparison above to isolate K2 and K3.
"""
from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main():
    for mod in ('jax', 'flax', 'kgdet_tpu'):
        sys.modules[mod] = None
    import torch

    import chip_smoke as cs
    from kgdet_tpu_torch.api import init_trainer, load_config
    from kgdet_tpu_torch.ops import _build, plain_kernels
    from kgdet_tpu_torch.ops.image import device_normalize
    from kgdet_tpu_torch.parallel.train import make_loss_fn

    n_samples = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    _build.build_all()
    cfg = load_config(cs.CONFIG)
    model, optimizer, train_step = init_trainer(cfg, cs.CANVAS,
                                                steps_per_epoch=1000)
    params = dict(model.named_parameters())
    loss_fn = make_loss_fn(model, cfg, cs.CANVAS)

    first = cs.make_train_batches(1, 123, cfg.head.num_keypts)[0]
    image = device_normalize(torch.as_tensor(first['image']).cuda(),
                             torch.as_tensor(first['valid_hw']).cuda())
    for dtype in (torch.float32, torch.bfloat16):
        want = model.backbone.frozen_prefix(image.to(dtype))
        differing = sum(
            not torch.equal(model.backbone.frozen_prefix(image.to(dtype)),
                            want) for _ in range(100))
        print(f'frozen prefix on its kernels, {dtype}: {differing} of 100 '
              f'runs differ from the first', flush=True)

    def loss_and_grads(plain, batch):
        model.dtype = torch.float32
        optimizer.zero_grad()
        with plain_kernels(plain), cs.prefix_on_its_kernels(model):
            total, _ = loss_fn(batch)
        total.backward()
        return total.item(), {n: p.grad.float().clone()
                              for n, p in params.items()
                              if p.grad is not None}

    worst_all, worst_groups, share_groups = [], [], []
    for i, batch in enumerate(cs.make_train_batches(n_samples, 123,
                                                    cfg.head.num_keypts)):
        k_loss, kern = loss_and_grads(False, batch)
        p_loss, plain = loss_and_grads(True, batch)
        rows = []
        for n, want in plain.items():
            diff = (kern[n] - want).abs() / want.abs().max()
            rows.append((diff.max().item(), n,
                         (diff > cs.MODEL_F32_REL).sum().item(),
                         diff.numel()))
        worst_all.append(max(rows)[0])
        grouped = [r for r in rows if r[1].startswith(cs.GRAD_GROUPS)]
        worst_groups.append(max(grouped)[:2])
        share_groups.append(sum(r[2] for r in grouped)
                            / sum(r[3] for r in grouped))
        if worst_all[-1] > 1e-4:
            top = ', '.join(f'{n} {e:.3e} ({k} of {m} elements beyond '
                            f'{cs.MODEL_F32_REL})'
                            for e, n, k, m in sorted(rows, reverse=True)[:3])
            print(f'sample {i}: loss differs by {abs(k_loss - p_loss):.3e}; '
                  f'{top}', flush=True)
        if i % 4 == 3:
            model.dtype = torch.bfloat16
            train_step(batch)
    worst_all.sort()
    n = len(worst_all)
    print(f'{n} samples, worst difference of any gradient, of its scale: '
          f'min {worst_all[0]:.3e} median {worst_all[n // 2]:.3e} p90 '
          f'{worst_all[int(n * 0.9)]:.3e} max {worst_all[-1]:.3e}; beyond '
          f'{cs.MODEL_F32_REL}: {sum(w > cs.MODEL_F32_REL for w in worst_all)}')
    print(f'groups {cs.GRAD_GROUPS}: worst {max(worst_groups)} (bound '
          f'{cs.MODEL_GRAD_REL}), largest share beyond {cs.MODEL_F32_REL}: '
          f'{max(share_groups):.3e} (bound {cs.MODEL_FLIP_SHARE})')
    return 0


if __name__ == '__main__':
    sys.exit(main())
