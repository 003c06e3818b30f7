#!/usr/bin/env python3
"""The two bodies of the sampling backward (K3) side by side, per shape.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 kgdet_tpu_torch/tools/bwd_regimes.py [rounds]

``deform_sample_bwd`` picks a body per shape inside its C launcher
(csrc/deform_bwd.cu): the slab body, which sums the map's gradient in
shared memory, where many taps land on a pixel and bands of map rows fit,
else the atomic body, which sends every add to global memory. This script
compiles the source twice more, with ``-DKGDET_BWD_REGIME=1`` (the atomic
body for every shape) and ``=2`` (the slab wherever its bands fit), into
build/bwd_regimes/ and times the three libraries through the same wrapper at
chip_smoke.py's shapes (bf16, batch 2): the cascade's call (25x42 map, 512
channels, 83 taps) and the five levels of the serial family (256 channels, 9
taps), each with taps spread uniformly over the map and with taps near their
own pixel (centre + N(0, 2 cells)). The time is the device's: 10 calls of
the wrapper (its fill and cast included) captured into a CUDA graph, the
median of 5 replays by CUDA events divided by 10. The sweep runs ``rounds``
times (default 2) in the order shipped, atomic, slab, slab, atomic, shipped.
Prints the card's name and power limit and one line a shape and tap set.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def build_regime(_build, regime):
    """csrc/deform_bwd.cu with one body for every shape (1: atomic, 2: slab
    where its bands fit), loaded."""
    out = _build.BUILD / 'bwd_regimes' / _build.source_hash() \
        / f'regime{regime}' / 'libdeform_bwd.so'
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS,
               f'-DKGDET_BWD_REGIME={regime}',
               '-o', str(out), str(_build.CSRC / 'deform_bwd.cu')]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f'nvcc failed:\n{proc.stdout}{proc.stderr}')
    lib = ctypes.CDLL(str(out))
    for fn, argtypes in _build.SIGNATURES['deform_bwd'].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main():
    for mod in ('jax', 'flax', 'kgdet_tpu'):
        sys.modules[mod] = None
    import torch

    import chip_smoke as cs
    from kgdet_tpu_torch.ops import _build
    from kgdet_tpu_torch.ops import deform_kernels as dk

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(cs.gpu_line(), flush=True)
    libs = {'shipped': _build.load('deform_bwd'),
            'atomic': build_regime(_build, 1),
            'slab': build_regime(_build, 2)}
    gen = torch.Generator().manual_seed(cs.SEED)
    B, bf16 = cs.B, torch.bfloat16

    def inputs(H, W, C, K, near):
        P = H * W
        feat = torch.randn((B, H, W, C), generator=gen).cuda().to(bf16)
        g = torch.randn((B, P, K, C), generator=gen).cuda().to(bf16)
        if near:
            ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W),
                                    indexing='ij')
            pos = torch.stack([ys, xs], dim=-1).reshape(1, P, 1, 2) \
                + 2.0 * torch.randn((B, P, K, 2), generator=gen)
        else:
            pos = torch.rand((B, P, K, 2), generator=gen) \
                * torch.tensor([H + 4.0, W + 4.0]) - 2.0
        return feat, pos.cuda().contiguous(), g

    shapes = [('cascade 25x42x512 K=83', 25, 42, 512, 83)] + [
        (f'serial {H}x{W}x256 K=9', H, W, 256, 9)
        for H, W in cs.SERIAL_LEVELS]
    cases = [(f'{name}, {"near" if near else "uniform"} taps',
              inputs(H, W, C, K, near))
             for name, H, W, C, K in shapes for near in (False, True)]

    def device_ms(fn, calls=10):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        return cs.median_ms(graph.replay, reps=5, warmup=1) / calls

    times = {name: {k: [] for k in libs} for name, _ in cases}
    order = ['shipped', 'atomic', 'slab', 'slab', 'atomic', 'shipped']
    for _ in range(rounds):
        for which in order:
            _build._LIBS['deform_bwd'] = libs[which]
            for name, args in cases:
                times[name][which].append(
                    device_ms(lambda: dk.deform_sample_bwd(*args)))
    _build._LIBS['deform_bwd'] = libs['shipped']

    print(f'device ms a call (fill, kernel, cast) by CUDA graph replays, '
          f'bf16, batch {B}: least of {2 * rounds} and all values')
    for name, t in times.items():
        best = {k: min(v) for k, v in t.items()}
        print(f'{name}: shipped {best["shipped"]:.4f}, atomic body '
              f'{best["atomic"]:.4f}, slab body {best["slab"]:.4f} | '
              + ' | '.join(f'{k} ' + ' / '.join(f'{v:.4f}' for v in t[k])
                           for k in libs), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
