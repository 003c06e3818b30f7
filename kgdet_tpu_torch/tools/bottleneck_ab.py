#!/usr/bin/env python3
"""The frozen-bottleneck kernels K5 and K8 of two checkouts, in turns.

Run from the repository root, on a machine with a CUDA card and nvcc, with
another checkout of the repository (an unpacked ``git archive`` of another
commit) at OTHER:

    python3 kgdet_tpu_torch/tools/bottleneck_ab.py OTHER [rounds]

Each measurement is a fresh process that imports one checkout's
``kgdet_tpu_torch`` (its kernels built from its own csrc/ into its own
build/) and its ``chip_smoke.py``, and reports K5 and K8 at chip_smoke.py's
layer1 shapes (bf16, batch 2, 200x336, the three blocks: Cin 64 with a
downsample, Cin 256 twice, width 64, Cout 256; seeded weights): the
device time of the kernels of one call summed over the three blocks, by
``chip_smoke.device_profile`` (10 calls under torch.profiler). K5 runs
through ``frozen_bottleneck_prepared``; K8 through
``fused_bottleneck_prepared`` where the checkout has it, else through
``fused_bottleneck`` (whose casts are not the port's kernels and are not
counted). The processes run in the order OTHER, this, this, OTHER,
``rounds`` times (default 1). Prints the card's name and power limit, one
line a process, and the mean of each checkout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def measure(root):
    """K5's and K8's device ms for the three layer1 blocks, in the checkout
    at ``root`` (run in a process of its own)."""
    for mod in ('jax', 'flax', 'kgdet_tpu'):
        sys.modules[mod] = None
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from kgdet_tpu_torch.ops import resblock as rb
    from kgdet_tpu_torch.ops import stem_kernels as sk
    gen = torch.Generator().manual_seed(cs.SEED)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).cuda()
    H4, W4 = cs.CANVAS[0] // 4, cs.CANVAS[1] // 4
    k5 = k8 = 0.0
    for i, cin in enumerate((64, 256, 256)):
        x = torch.relu(randn(cs.B, H4, W4, cin)).bfloat16()
        blk = [randn(cin, 64, std=cin ** -0.5), randn(64, std=0.1),
               randn(3, 3, 64, 64, std=(9 * 64) ** -0.5), randn(64, std=0.1),
               randn(64, 256, std=64 ** -0.5), randn(256, std=0.1)]
        blk += ([randn(cin, 256, std=cin ** -0.5), randn(256, std=0.1)]
                if i == 0 else [None, None])
        kept = sk.prepare_block(dict(zip(sk.BLOCK_KEYS, blk)),
                                torch.bfloat16)
        k5 += cs.device_profile(
            lambda: sk.frozen_bottleneck_prepared(x, kept))[0]
        if hasattr(rb, 'fused_bottleneck_prepared'):
            k8 += cs.device_profile(
                lambda: rb.fused_bottleneck_prepared(x, kept))[0]
        else:
            k8 += cs.device_profile(lambda: rb.fused_bottleneck(x, *blk))[0]
    return {'k5_ms': k5, 'k8_ms': k8}


def main():
    if len(sys.argv) > 1 and sys.argv[1] == '--measure':
        print(json.dumps(measure(os.path.abspath(sys.argv[2]))))
        return 0
    other = os.path.abspath(sys.argv[1])
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    import torch
    if not torch.cuda.is_available():
        print('bottleneck_ab: no CUDA device', file=sys.stderr)
        return 1
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    runs = {other: [], ROOT: []}
    for _ in range(rounds):
        for root in (other, ROOT, ROOT, other):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--measure',
                 root], capture_output=True, text=True, cwd=root)
            if proc.returncode:
                print(proc.stdout[-2000:], proc.stderr[-4000:])
                return 1
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[root].append(got)
            name = 'this' if root == ROOT else 'other'
            print(f'{name} ({root}): K5 three blocks {got["k5_ms"]:.4f} ms, '
                  f'K8 {got["k8_ms"]:.4f} ms on the device', flush=True)
    for root, got in runs.items():
        name = 'this' if root == ROOT else 'other'
        print(f'mean {name}: K5 {sum(g["k5_ms"] for g in got) / len(got):.4f}'
              f' ms, K8 {sum(g["k8_ms"] for g in got) / len(got):.4f} ms '
              f'over {len(got)} processes', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
