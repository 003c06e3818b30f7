#!/usr/bin/env python3
"""What each design choice of the column gathers (K6, K2) is worth.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 kgdet_tpu_torch/tools/gather_tuning.py [rounds]

Times ``deform_sample_cols`` (K6) at the five levels of the serial family
and ``deform_sample_split`` (K2) at the cascade's training shape, bf16,
batch 2 (chip_smoke.py's shapes), with the kernels' three design constants
set to every other value: taps in flight per warp (1, 2, 4), streaming or
plain column stores, and a persistent grid of 8, 16 or 32 blocks of 256
threads per SM. The port's own libraries hold one value of each; this
script compiles csrc/deform_sample.cu and csrc/deform_split.cu once more per
combination, with the KGDET_GATHER_* macros of csrc/deform_gather.cuh set on
nvcc's command line, into build/gather_tuning/, and puts each pair of
libraries in the wrappers' place for its measurement.
Two sets of positions: ``random``, uniform over the map and two cells
beyond it (chip_smoke.py's phase 1: no two taps share a corner), and
``near``, every tap within a few cells of its own pixel as a head at its
initial weights places them (K6: the 3x3 grid around the pixel plus noise
of 0.5 cell; K2: the pixel plus noise of 1.5 cells), where the taps of a
pixel and of its neighbours overlap. The time is the device's: 20 calls of
the wrapper are captured into a CUDA graph, and the median of 5 replays by
CUDA events is divided by 20, so the host does not enter (the gap between
two kernels of a graph, about a microsecond, does). The sweep runs
``rounds`` times (default 2) in the order forward, backward, ... so that a
drift of the card shows as a spread between rounds, not as a difference
between tunings. Prints the card's name
and power limit, one line per tuning (K6: the sum over the ten launches of a
train step and the stride-8 level alone; K2: one call) with its bytes bound
beside it, then per kernel and position set the fastest tuning and the
place of the one the port ships.
"""
from __future__ import annotations

import ctypes
import itertools
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


GATHERS = ('deform_sample', 'deform_split')


def build_variants(_build, tunings):
    """{tuning: {source name: loaded library}}: both gathers compiled with
    the tuning's macros, as many nvcc processes at a time as there are
    cores."""
    nvcc = _build.find_nvcc()
    root = _build.BUILD / 'gather_tuning' / _build.source_hash()
    jobs = []
    for nt, plain, per_sm in tunings:
        for name in GATHERS:
            out = root / f'nt{nt}_plain{plain}_sm{per_sm}' / f'lib{name}.so'
            out.parent.mkdir(parents=True, exist_ok=True)
            jobs.append(((nt, plain, per_sm), name, out, [
                nvcc, *_build.NVCC_FLAGS,
                f'-DKGDET_GATHER_TAPS_IN_FLIGHT={nt}',
                f'-DKGDET_GATHER_PLAIN_STORES={plain}',
                f'-DKGDET_GATHER_BLOCKS_PER_SM={per_sm}',
                '-o', str(out), str(_build.CSRC / f'{name}.cu')]))
    width = os.cpu_count() or 1
    for lo in range(0, len(jobs), width):
        procs = [(job, subprocess.Popen(job[3], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for job in jobs[lo:lo + width] if not job[2].exists()]
        for job, proc in procs:
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f'nvcc failed for {job[2]}:\n{log}')
    libs = {}
    for tune, name, out, _ in jobs:
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs.setdefault(tune, {})[name] = lib
    return libs


def main():
    for mod in ('jax', 'flax', 'kgdet_tpu'):
        sys.modules[mod] = None
    import torch

    import chip_smoke as cs
    from kgdet_tpu_torch.ops import _build
    from kgdet_tpu_torch.ops import deform_kernels as dk

    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(cs.gpu_line(), flush=True)
    _build.build_all()
    gen = torch.Generator().manual_seed(cs.SEED)
    B, C = cs.B, 256
    bf16 = torch.bfloat16

    def inputs(H, W, K, maps, near):
        feats = [torch.randn((B, H, W, C), generator=gen).cuda().to(bf16)
                 for _ in range(maps)]
        P = H * W
        if near:
            ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W),
                                    indexing='ij')
            pos = torch.stack([ys, xs], dim=-1).reshape(1, P, 1, 2).float()
            if K == 9:          # the regular 3x3 grid of a deformable conv
                dy, dx = torch.meshgrid(torch.arange(-1, 2),
                                        torch.arange(-1, 2), indexing='ij')
                pos = pos + torch.stack([dy, dx], dim=-1).reshape(1, 1, 9, 2)
            noise = 0.5 if K == 9 else 1.5
            pos = (pos + noise * torch.randn((B, P, K, 2),
                                             generator=gen)).cuda()
        else:
            pos = torch.rand((B, P, K, 2), generator=gen).cuda() \
                * torch.tensor([H + 4.0, W + 4.0], device='cuda') - 2.0
        return feats, pos.contiguous()

    taps = (9, 25, 49)
    cases = {}
    for name, near in (('random', False), ('near', True)):
        cases[name] = (
            [inputs(H, W, 9, 1, near) for H, W in cs.SERIAL_LEVELS],
            inputs(25, 42, sum(taps), 2, near))

    def bound_ms(feats, pos):       # every input once, every sample once
        n = pos[..., 0].numel() * C * len(feats) * 2
        return (cs.nbytes(*feats, pos) + n) / cs.HBM_BYTES_PER_S * 1e3

    levels, (split_feats, split_pos) = cases['random']
    k6_bound = 2 * sum(bound_ms(f, p) for f, p in levels)
    k2_bound = bound_ms(split_feats, split_pos)

    def device_ms(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        return cs.median_ms(graph.replay, reps=5, warmup=1) / calls

    tunings = list(itertools.product((1, 2, 4), (0, 1), (8, 16, 32)))
    variants = build_variants(_build, tunings)
    shipped = {name: _build.load(name) for name in GATHERS}
    keys = [f'{kernel} {name}' for name in cases
            for kernel in ('k6', 'k6_s8', 'k2')]
    times = {t: {k: [] for k in keys} for t in tunings}
    for r in range(rounds):
        for tune in (tunings if r % 2 == 0 else tunings[::-1]):
            _build._LIBS.update(variants[tune])     # what load() hands out
            for name, (levels, (feats, pos)) in cases.items():
                per_level = [device_ms(
                    lambda: dk.deform_sample_cols(f[0], p))
                    for f, p in levels]
                times[tune][f'k6 {name}'].append(2 * sum(per_level))
                times[tune][f'k6_s8 {name}'].append(per_level[0])
                times[tune][f'k2 {name}'].append(device_ms(
                    lambda: dk.deform_sample_split(*feats, pos, taps)))
    _build._LIBS.update(shipped)

    def show(vals):
        return ' / '.join(f'{v:.4f}' for v in vals)

    print(f'device ms by CUDA graph replays, bf16, batch {B}, one value per '
          f'round; bounds by bytes: K6 x10 {k6_bound:.4f} ms (stride 8 '
          f'alone {bound_ms(*cases["random"][0][0]):.4f}), K2 '
          f'{k2_bound:.4f} ms')
    print('taps in flight, stores, blocks/SM | ' + ' | '.join(keys))
    for (nt, plain, per_sm), t in times.items():
        print(f'{nt} {"plain" if plain else "streaming":9s} {per_sm:2d} | '
              + ' | '.join(show(t[k]) for k in keys), flush=True)
    for key in keys:
        if key.startswith('k6_s8'):
            continue
        # the constants of csrc/deform_split.cu and csrc/deform_sample.cu
        bound, default = (k2_bound, (1, 0, 16)) if key.startswith('k2') \
            else (k6_bound, (4, 0, 16))
        ranked = sorted(tunings, key=lambda t: min(times[t][key]))
        best = min(times[ranked[0]][key])
        mine = min(times[default][key])
        print(f'{key}: fastest {ranked[0]} at {best:.4f} ms '
              f'({best / bound:.2f}x its bound); the shipped {default} is '
              f'number {ranked.index(default) + 1} of {len(ranked)} at '
              f'{mine:.4f} ms ({mine / bound:.2f}x)')
    return 0


if __name__ == '__main__':
    sys.exit(main())
