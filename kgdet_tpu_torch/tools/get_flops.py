"""Model parameters, FLOPs and kernel bytes of one forward.

Port of kgdet_tpu/tools/get_flops.py (parity surface: reference
tools/get_flops.py, a module-hook FLOPs counter at 1280x800). The JAX tool
reads XLA's cost analysis of the compiled forward; here the library ops
are counted by ``torch.utils.flop_counter.FlopCounterMode`` and each of the
port's kernels by the arithmetic registered beside its wrapper
(ops/kernel_cost.py, PERF.md section 6's bound formulas), so the count is
the same on the CPU (plain versions) and on the card (the kernels). The
bytes line counts what the port's kernels must move, each input read once
and each output written once; it is not XLA's HBM bytes, which measure
another thing. On the CUDA card unless ``--device`` says otherwise:

  python -m kgdet_tpu_torch.tools.get_flops configs/..._demo.py \
      [--shape 1280 800] [--device cpu]

``main(argv)`` also returns the numbers.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('--shape', type=int, nargs=2, default=(1280, 800),
                   help='input H W (padded to the stride divisor)')
    p.add_argument('--device', default=None,
                   help='torch device; default the CUDA card, an error '
                        'where there is none')
    return p.parse_args(argv)


def count_forward(model, x):
    """(library FLOPs, the port kernels' Tally) of ``model(x)`` without a
    gradient."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from kgdet_tpu_torch.ops.kernel_cost import tally

    with torch.no_grad(), tally() as kernels:
        counter = FlopCounterMode(display=False)
        with counter:
            model(x)
    return counter.get_total_flops(), kernels


def main(argv=None):
    args = parse_args(argv)
    import torch

    from kgdet_tpu_torch.api import build_model, resolve_device
    from kgdet_tpu_torch.config import load_config

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    model = build_model(cfg, device='cpu').init_weights(cfg.seed)
    model = model.to(device).eval()

    div = cfg.train_data.size_divisor
    H = -(-args.shape[0] // div) * div
    W = -(-args.shape[1] // div) * div
    x = torch.zeros((1, H, W, 3), dtype=torch.float32, device=device)
    lib_flops, kernels = count_forward(model, x)
    n_params = sum(p.numel() for p in model.parameters())
    flops = lib_flops + kernels.flops
    print(f'Input shape: (1, {H}, {W}, 3)')
    print(f'Params: {n_params / 1e6:.2f} M')
    print(f'FLOPs (library ops + port kernels): {flops / 1e9:.2f} GFLOPs')
    for name, k in sorted(kernels.kernels.items()):
        print(f'  {name}: {k["calls"]} calls, {k["flops"] / 1e9:.3f} '
              f'GFLOPs, {k["bytes"] / 1e9:.4f} GB')
    print(f'bytes (port kernels): {kernels.bytes / 1e9:.3f} GB')
    return {'shape': (1, H, W, 3), 'params': n_params, 'flops': flops,
            'library_flops': lib_flops, 'kernel_flops': kernels.flops,
            'kernel_bytes': kernels.bytes,
            'kernels': {k: dict(v) for k, v in kernels.kernels.items()}}


if __name__ == '__main__':
    main()
