#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kgdet_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Setup: builds the hand-written kernels from kgdet_tpu_torch/csrc/ with nvcc
(sm_90a) and times the build.
Phase 1: each kernel (K1 deform_fused, K2 deform_sample_split, K3
deform_sample_bwd, K4 stem_pool, K5 frozen_bottleneck, K6 deform_sample_cols,
K8 fused_bottleneck) against its plain PyTorch version at the main paths'
shapes (batch 2: the cascade's 25x42 map with 9/25/49 taps, the five levels
of the serial family with 9 taps, the 200x336 layer1 input), in f32 (rtol
1e-5, atol 1e-4; for K3, whose f32 atomics sum in an order that changes from
run to run, atol 1e-4 of the largest sum) and in bf16 (the kernel's max
error against an f32 plain run is at most 2x the bf16 plain run's), with
the median time of the wrapper call by CUDA events, the kernel's own device
time and the number of device activities a call by torch.profiler (every
deformable kernel takes positions and does its index math inside: a call of
K1, K2 or K6 must put exactly one kernel on the device, a call of K3 one
kernel of the port plus at most a fill and a cast; K4 and K5 are called
through their prepared entries on weights kept per dtype, as the model
keeps them, and must be one kernel a call too), each kernel's bound
(the least time the card could take, from the bytes and operations of this
run's inputs) and, for K2, K3 and K6, the time of F.grid_sample and of its
backward as a yardstick that the port never calls; K3 is checked and timed
twice, with taps spread uniformly over the map and with taps near their own
pixel (centre + N(0, 2 cells)), which is where a scatter's adds collide; K8
is called through its prepared entry too (one kernel a call), held against
K5 on the same inputs (f32: within the tolerance, each on its FMA body;
bf16: bit for bit, one tensor-core body), shown by the kernel's name to run
the 16x16 tensor-core body, and checked and timed once more at width 128
(layer2's stride-1 block at layer1's map size, the 8x16 tile). After the
build, ptxas's registers and spills a kernel and, by cuobjdump, the bf16
tensor-core instructions and local-memory accesses in the SASS of the
bottleneck bodies of K5 and K8 (fails if a tensor-core instance has none).
Phase 2: serves 2 requests of 2 uint8 images at full width
(configs/kgdet_moment_r50_fpn_1x_deepfashion2.py, bf16, 800x1344, seeded
random weights) through make_predict_fn, checks the launch counts and the
outputs, and compares the last-stage head outputs with the same model on its
plain kernels, in bf16 and in f32.
Phase 3: where the time goes: torch.profiler over served batches run stage
by stage (normalize, backbone, neck, head, decode), giving device time per
stage and per kernel and the device's idle share of the window.
Phase 4: training: builds the same model through init_trainer, takes one
warm-up and two timed steps of make_train_step on seeded synthetic batches
(16 boxes an image), checks the launch counts per step (K2 2, K3 2, K1 0,
K4 1, K5 3), finite loss and gradient norm, a frozen parameter bit-equal and
a free one moved; then holds the autograd Function over K2 and K3 against
the one over their plain versions on the very tensors that the train step's
forward hands the two deformable stages (f32, every output and gradient
within 1e-3 of its scale), and compares, on one batch in f32 and in bf16,
the loss and the gradients of kp_rep_block_2/3 and layer4 between the model
on its kernels and on their plain versions.
Phase 5: the train step by stage (forward backbone / neck / head, loss and
targets, backward, optimizer) under torch.profiler.
Phase 6: the serial family served: phases 2 and 3 on
configs/reppoints_moment_serial_r50_fpn_1x_deepfashion2.py (5-level FPN,
launches K1 10 / K4 1 / K5 3 per forward, every level's refine-stage
outputs compared), and one served batch of the parallel config, whose pts
branch runs K1 at F = 512.
Phase 7: the serial family trained: init_trainer on the serial config, one
warm-up and two timed steps (launches per step K6 10, K3 10, K1 0, K2 0,
K4 1, K5 3), the same checks as phase 4, the autograd Function over K6 and
K3 against the one over their plain versions on the tensors the step hands
the stride-8 and the stride-32 level, the model's gradients with K6+K3
against their plain versions on the same prefix, and the step by stage.
Phase 8 (run on phase 6's model, before phase 7): the ResNet-50 backbone
with the per-block frozen layer1 (prefix_pipeline=False): launches K8 3 /
K5 0 / K4 0, its C2 output against the K4+K5 chain and against the all-plain
route, the chain's bf16 error within 2x the plain chain's, and its time
beside the chain's; what each route puts on the device on its kept weights
(activities, device time): the per-block route's three K8 launches must run
the 16x16 tensor-core body, and the served frozen prefix must put exactly
four activities on the device, K4 and K5 x3.
Phase 9: the evaluation path at full width on the cascade config (bf16,
seeded random weights, val_data as shipped: batch 8, canvases 800x1344 and
1344x800, img_scale (1333, 800); test.score_thr 0): writes a synthetic
DeepFashion2-style validation set of 192 PNGs (NumPy + zlib; 24 batches),
checks that the evaluator scores its own ground truth at all-area AP 1
(bbox and keypoints), holds the last-stage head outputs of the model on its
kernels against on their plain versions on the first batch of 8 of each
canvas (as phase 2 does at batch 2), runs the CLI
kgdet_tpu_torch/tools/test.py in-process (every image once in the results,
both JSON files, 12 / 10 finite numbers on the copypaste lines, launches K1
12 / K4 1 / K5 3 a batch over the batches of both canvases and no other
kernel), holds run_inference's detections of the first batch bit for bit
against a direct make_predict_fn call, and runs multi-scale / flip TTA on 4
images (scales at, below and beyond the canvas buckets). Prints the
image_io backend, host data and predict ms a batch, the CLI's setup,
inference and evaluation seconds, and its img/s over the inference window,
the evaluation and the whole run.

Prints the card's name and power limit, one line per check, a JSON line of
the seven kernels (launches on each main path, the evaluation CLI's
included, error, wrapper and device times, bound), and as
its last line {"ok": true, "device": {...}}. Exits
nonzero, with no result line, when a check fails or no CUDA device is
present. Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs',
                      'kgdet_moment_r50_fpn_1x_deepfashion2.py')
SERIAL_CONFIG = os.path.join(
    ROOT, 'configs', 'reppoints_moment_serial_r50_fpn_1x_deepfashion2.py')
PARALLEL_CONFIG = os.path.join(
    ROOT, 'configs', 'reppoints_moment_parallel_r50_fpn_1x_deepfashion2.py')
# the five levels of the serial family on the canvas: strides 8 to 128
SERIAL_LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21), (7, 11))
B = 2
CANVAS = (800, 1344)
SEED = 0
F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_RATIO = 2.0
# tight f32 bound, relative to each output's scale: both sides are f32 end
# to end and differ only in summation order
MODEL_F32_REL = 1e-3
# f32 gradients of the whole model on its kernels against the whole model on
# their plain versions, relative to each gradient's largest value: no
# element may differ by more. The bound is loose because the gradients of a
# ReLU network are not continuous. The block applies a ReLU to the
# Function's output, and a pre-activation within rounding of zero falls on
# different sides in the two models: the loss does not move, but that
# pixel's cotangent of that channel is there or is not, which changes one
# term of the sums in one channel's slice of one weight gradient, and a
# little of every gradient upstream. Over 650 batches and weight states
# (NVIDIA H100 80GB HBM3, 700 W; kgdet_tpu_torch/tools/grad_discontinuity.py)
# 17 had an element beyond 1e-3, the worst at 4.5e-3 of its scale, in 0.1%
# of one weight's elements or a few elements of a small parameter (3e-5 of
# the compared elements); the median of the worst difference was 8e-6.
# A difference in the frozen prefix (1e-6 in its f32 output) passes many
# more ReLUs and moves single weights by 1e-2, as one bit of one input
# pixel does. So K2 and K3 are held to MODEL_F32_REL where no ReLU
# intervenes (the Function on the train step's own tensors), and the model
# with the prefix kept the same on both sides is held to MODEL_F32_REL in
# all but MODEL_FLIP_SHARE of the compared elements
MODEL_GRAD_REL = 5e-2
MODEL_FLIP_SHARE = 1e-2
# published peaks of the H100 SXM (NVIDIA data sheet): device memory rate,
# dense bf16 tensor-core rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {'bf16': 989e12, 'f32': 67e12}
TRAIN_STEPS = 2
SERVED = 2


def fail(msg):
    raise SystemExit(f'chip_smoke: FAIL: {msg}')


def gpu_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ''


def build_report(build, logs):
    """What nvcc made of the kernels: ptxas's registers and spills a kernel
    (from the build's logs), and for the frozen-bottleneck bodies of
    libresblock.so (K8) and libstem_layer1.so (K5) the count of bf16
    tensor-core instructions (HMMA.16816.F32.BF16) and of local-memory
    loads and stores (LDL, STL: spills) in their SASS, by cuobjdump. Fails
    unless every instance of the tensor-core body (bottleneck_mma_kernel)
    holds the bf16 MMA."""
    for name, log in logs.items():
        fn = ''
        for line in log.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            fn = m.group(1) if m else fn
            if 'registers' in line or 'spill' in line:
                print(f'  {name} {fn[:72]}: {line.strip()}')
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), 'cuobjdump')
    for name in ('resblock', 'stem_layer1'):
        sass = subprocess.run([cuobjdump, '-sass', str(build.lib_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        parts = re.split(r'Function : (\S+)', sass)
        for fn, body in zip(parts[1::2], parts[2::2]):
            if 'bottleneck' not in fn:
                continue
            hmma = body.count('HMMA.16816.F32.BF16')
            local = len(re.findall(r'\b(?:LDL|STL)\b', body))
            tile = re.search(r'ILi(\d+)ELi(\d+)E', fn)
            what = f'tile {tile.group(1)}x{tile.group(2)}' if tile else ''
            print(f'  SASS lib{name}.so {fn[:48]} {what}: '
                  f'HMMA.16816.F32.BF16 x{hmma}, LDL/STL x{local}',
                  flush=True)
            if 'bottleneck_mma_kernel' in fn and hmma == 0:
                fail(f'{fn} in lib{name}.so has no bf16 tensor-core MMA')


def median_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_profile(fn, reps=10, names=None):
    """What one call of ``fn`` puts on the device, under torch.profiler over
    ``reps`` calls: (device ms a call of the port's own kernels, the
    ``kgdet::`` ones; device activities a call: every kernel, copy and
    memset, the library's included; the port's own kernels a call). With a
    dict ``names``, also names['own'], the port's kernels by short name,
    and names['device_ms'], the device time a call of every activity. Short
    recordings in quick succession now and then come back with device
    records missing, at a recording's edges more than inside it: the calls
    are bracketed by four short spin kernels on each side, which are not
    counted, and a recording counts when it holds the port's kernels in a
    multiple of ``reps``, else it is taken again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def bracket():
        for _ in range(4):
            torch.cuda._sleep(1000)
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            bracket()
            for _ in range(reps):
                fn()
            bracket()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and 'spin_kernel' not in e.name]
        own = [e.time_range.end - e.time_range.start for e in dev
               if 'kgdet::' in e.name]
        if own and len(own) % reps == 0:
            if names is not None:
                names['own'] = sorted({short_name(e.name) for e in dev
                                       if 'kgdet::' in e.name})
                names['device_ms'] = sum(
                    e.time_range.end - e.time_range.start
                    for e in dev) / 1e3 / reps
            return sum(own) / 1e3 / reps, len(dev) / reps, len(own) / reps
        order = [short_name(e.name) for e in
                 sorted(dev, key=lambda e: e.time_range.start)]
        print(f'device_profile: {len(own)} records of the port\'s kernels '
              f'in {reps} calls, recording {attempt + 1} taken again; in '
              f'order: {order}', flush=True)
    fail('the profiler lost device records in five recordings')


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def tensors(out):
    """A kernel's result, a tensor or nested sequences of them, as a flat
    list."""
    import torch
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in tensors(o)]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, ops, kind):
    """(ms, 'bytes' | 'operations'): the least time the card could take,
    the larger of bytes over the memory rate and operations over the peak
    rate of their type."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops \
        else 'operations'


def check_pair(name, kernel, plain, args_f32, cast_bf16, scaled=False):
    """Kernel vs plain on the same inputs, every output tensor: f32 within
    F32_TOL (``scaled``: atol times the output's largest value, for sums
    whose order changes from run to run); bf16 kernel error vs the f32 plain
    run at most BF16_RATIO x the bf16 plain run's (an output that both
    compute in f32 from the same bf16 values differs only by summation
    order, and is held to the f32 tolerance instead).
    Returns (measurements, bf16 args): the f32 max err, the bf16 medians by
    CUDA events of the wrapper call (``ms``) and of the plain version, the
    kernel's own device time a call (``device_ms``), the device activities
    a call (``device_kernels``, whatever torch the wrapper runs included)
    and the port's own kernels among them (``own_kernels``), all three by
    torch.profiler."""
    import torch
    got, want = tensors(kernel(*args_f32)), tensors(plain(*args_f32))
    torch.cuda.synchronize()
    e32 = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f'{name}: shape {tuple(g.shape)} != {tuple(w.shape)}')
        atol = F32_TOL['atol'] * (max(1.0, w.abs().max().item())
                                  if scaled else 1.0)
        if not torch.allclose(g.float(), w.float(), rtol=F32_TOL['rtol'],
                              atol=atol):
            fail(f'{name} f32: max abs err {max_err(g, w):.3e} over '
                 f'rtol {F32_TOL["rtol"]} atol {atol:.1e}')
        e32 = max(e32, max_err(g, w))
    if len(got) != len(want):
        fail(f'{name}: {len(got)} outputs != {len(want)}')

    args16 = cast_bf16(args_f32)
    ref = tensors(plain(*[a.float() if torch.is_tensor(a)
                          and a.is_floating_point() else a for a in args16]))
    k16, p16 = tensors(kernel(*args16)), tensors(plain(*args16))
    torch.cuda.synchronize()
    ek = ep = 0.0
    for k, p, r in zip(k16, p16, ref):
        eki, epi = max_err(k, r), max_err(p, r)
        floor = 0.0
        if k.dtype == torch.float32:
            floor = F32_TOL['atol'] * max(1.0, r.abs().max().item())
        if not torch.isfinite(k.float()).all() \
                or eki > max(BF16_RATIO * epi, floor):
            fail(f'{name} bf16: kernel err {eki:.3e} > {BF16_RATIO} x plain '
                 f'err {epi:.3e}')
        ek, ep = max(ek, eki), max(ep, epi)
    ms = median_ms(lambda: kernel(*args16))
    pms = median_ms(lambda: plain(*args16))
    dms, n_dev, n_own = device_profile(lambda: kernel(*args16))
    print(f'{name}: f32 max_abs_err {e32:.3e} | bf16 max_abs_err vs f32 '
          f'plain: kernel {ek:.3e}, plain {ep:.3e} | bf16 median ms: '
          f'kernel {ms:.4f} (on the device {dms:.4f}, {n_dev:g} device '
          f'activities a call), plain {pms:.4f}', flush=True)
    return {'max_abs_err': e32, 'ms': ms, 'plain_ms': pms, 'device_ms': dms,
            'device_kernels': n_dev, 'own_kernels': n_own}, args16


def entry(measured, bound_ms, bound_by, library_ms=None):
    return {**measured, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': library_ms}


def merge(entries, calls=1):
    """One row for several shapes of one kernel, ``calls`` launches of each
    on the main path: times and bounds add up, the error and the device
    activities a call are the largest."""
    measured = {k: calls * sum(e[k] for e in entries)
                for k in ('ms', 'plain_ms', 'device_ms')}
    for k in ('max_abs_err', 'device_kernels', 'own_kernels'):
        measured[k] = max(e[k] for e in entries)
    worst = max(entries, key=lambda e: e['bound_ms'])
    library = None if any(e['library_ms'] is None for e in entries) \
        else calls * sum(e['library_ms'] for e in entries)
    return entry(measured, calls * sum(e['bound_ms'] for e in entries),
                 worst['bound_by'], library_ms=library)


def phase_kernels(torch, gen):
    import torch.nn.functional as F

    from kgdet_tpu_torch.ops import deform_kernels as dk
    from kgdet_tpu_torch.ops import resblock as rb
    from kgdet_tpu_torch.ops import stem_kernels as sk
    from kgdet_tpu_torch.ops.deform import bilinear_gather

    dev = 'cuda'
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev)

    def rand_pos(H, W, P, K):       # up to 2 cells outside the map
        pos = torch.rand((B, P, K, 2), generator=gen).to(dev)
        return pos * torch.tensor([H + 4.0, W + 4.0], device=dev) - 2.0

    def near_pos(H, W, K):          # every tap near its own pixel
        ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W),
                                indexing='ij')
        centre = torch.stack([ys, xs], dim=-1).reshape(1, H * W, 1, 2)
        noise = 2.0 * torch.randn((B, H * W, K, 2), generator=gen)
        return (centre + noise).to(dev)

    def out_bytes(fn, args):
        return nbytes(*tensors(fn(*args)))

    def cast(args):                 # K1's (feat, pos, weight) in bf16
        f, p, wt = args
        return [f.to(bf16), p, wt.to(bf16)]

    def k1_ops(P, t, C, F):
        # the contraction, plus 7 operations a sampled value for the lerp
        return 2 * B * P * t * C * F + 7 * B * P * t * C

    def library_sampling(feat, pos, g):
        """F.grid_sample and its backward on the taps of K2 / K3 / K6, a
        yardstick only: checked in f32 to be the same function as the plain
        gather, then timed in bf16 (f32 where the library lacks bf16).
        feat (B,H,W,C), pos (B,P,K,2), cotangent g (B,P,K,C). Returns
        (forward ms, backward ms, f32 max err, dtype timed)."""
        H, W = feat.shape[1:3]

        def as_grid(dtype):         # (y, x) pixels -> normalized (x, y)
            return torch.stack([2 * pos[..., 1] / (W - 1) - 1,
                                2 * pos[..., 0] / (H - 1) - 1],
                               dim=-1).to(dtype)

        def grid_sample(x, grid):
            return F.grid_sample(x, grid, mode='bilinear',
                                 padding_mode='zeros', align_corners=True)
        nchw = feat.permute(0, 3, 1, 2).contiguous()
        lib32 = grid_sample(nchw, as_grid(torch.float32)).permute(0, 2, 3, 1)
        err = max_err(lib32, bilinear_gather(feat, pos))
        if err > 1e-3:
            fail(f'grid_sample is not the same function: max err {err:.3e}')
        g_nchw = g.permute(0, 3, 1, 2).contiguous()

        def timed(dtype):
            x = nchw.to(dtype).requires_grad_(True)
            grid = as_grid(dtype).requires_grad_(True)
            with torch.no_grad():
                fwd = median_ms(lambda: grid_sample(x, grid))
            out = grid_sample(x, grid)
            ct = g_nchw.to(dtype)
            return fwd, median_ms(lambda: torch.autograd.grad(
                out, (x, grid), ct, retain_graph=True))
        try:
            return (*timed(bf16), err, bf16)
        except RuntimeError as exc:  # the library lacks a bf16 grid_sample
            print(f'grid_sample in bf16: {str(exc)[:80]}; timed in f32')
            return (*timed(torch.float32), err, torch.float32)

    def one_launch(name, measured, others=0):
        # positions in, index math in the kernel: a call is one kernel of
        # the port and at most ``others`` other activities (a fill, a cast)
        if measured['own_kernels'] != 1 or \
                measured['device_kernels'] > 1 + others:
            fail(f'{name}: a call put {measured["device_kernels"]:g} '
                 f'activities on the device, {measured["own_kernels"]:g} of '
                 f'them the port\'s kernels, not one kernel and at most '
                 f'{others} others')

    def cast_bwd(a):                # K3's (feat, pos, g) in bf16
        return [a[0].to(bf16), a[1], a[2].to(bf16)]

    def check_bwd(name, feat, pos, g, library_ms):
        m, a16 = check_pair(
            f'K3 deform_sample_bwd {name} (sums by f32 atomics: their '
            f'order varies)', dk.deform_sample_bwd, dk.deform_sample_bwd_ref,
            [feat, pos, g], cast_bwd, scaled=True)
        one_launch(f'K3 deform_sample_bwd {name}', m, others=2)
        # a sampled value: 8 operations of scatter, 18 of the dot products
        return entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_sample_bwd, a16),
            26 * g.numel(), 'f32'), library_ms=library_ms)

    results = {}
    # K1 at the three column widths: map 25x42x256, P = 1050, F = 256
    H, W, C = 25, 42, 256
    P = H * W
    k1 = []
    for t in (9, 25, 49):
        feat = randn(B, H, W, C)
        pos = rand_pos(H, W, P, t)
        w = randn(t, C, C, std=(t * C) ** -0.5)
        m, a16 = check_pair(
            f'K1 deform_fused t={t}', dk.deform_conv_fused,
            dk.deform_conv_fused_ref, [feat, pos, w], cast)
        one_launch(f'K1 deform_fused t={t}', m)
        k1.append(entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_conv_fused, a16),
            k1_ops(P, t, C, C), 'bf16')))
    # 4 calls per column and forward: 2 deformable stages x 2 branches
    results['deform_fused'] = merge(k1, calls=4)

    # K2 and K3 at the training shapes: both branch maps, all 83 taps
    taps = (9, 25, 49)
    K = sum(taps)
    cls_feat, pts_feat = randn(B, H, W, C), randn(B, H, W, C)
    pos = rand_pos(H, W, P, K)
    m, a16 = check_pair(
        'K2 deform_sample_split', dk.deform_sample_split,
        dk.deform_sample_split_ref, [cls_feat, pts_feat, pos, taps],
        lambda a: [a[0].to(torch.bfloat16), a[1].to(torch.bfloat16), a[2],
                   a[3]])
    one_launch('K2 deform_sample_split', m)
    cat = torch.cat([cls_feat, pts_feat], dim=-1)
    g = randn(B, P, K, 2 * C)
    lib_ms, lib_bwd_ms, lib_err, lib_dtype = library_sampling(cat, pos, g)
    n_samples = B * P * K * 2 * C
    results['deform_sample_split'] = entry(m, *bound(
        nbytes(*a16[:3]) + out_bytes(dk.deform_sample_split, a16),
        7 * n_samples, 'f32'), library_ms=lib_ms)
    print(f'K2 yardstick F.grid_sample ({lib_dtype}, NCHW, never called by '
          f'the port): {lib_ms:.4f} ms, f32 max err vs plain {lib_err:.3e}',
          flush=True)

    results['deform_sample_bwd'] = check_bwd('uniform taps', cat, pos, g,
                                             lib_bwd_ms)
    pos = near_pos(H, W, K)
    _, near_bwd_ms, _, _ = library_sampling(cat, pos, g)
    results['deform_sample_bwd']['near'] = check_bwd(
        'taps near their pixel', cat, pos, g, near_bwd_ms)
    print(f'K3 yardstick backward of F.grid_sample ({lib_dtype}): uniform '
          f'taps {lib_bwd_ms:.4f} ms, near taps {near_bwd_ms:.4f} ms',
          flush=True)

    # the serial family's five levels, 9 taps a pixel: K1 (serving: the cls
    # and the pts branch of a level), K6 (training forward) and K3 (its
    # backward) on the same maps and positions
    K = 9
    k1s, k6, k3s, k3n = [], [], [], []
    for H, W in SERIAL_LEVELS:
        P = H * W
        feat, pos = randn(B, H, W, C), rand_pos(H, W, P, K)
        w = randn(K, C, C, std=(K * C) ** -0.5)
        g = randn(B, P, K, C)
        m, a16 = check_pair(
            f'K1 deform_fused serial level {H}x{W}', dk.deform_conv_fused,
            dk.deform_conv_fused_ref, [feat, pos, w], cast)
        one_launch(f'K1 deform_fused serial level {H}x{W}', m)
        k1s.append(entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_conv_fused, a16),
            k1_ops(P, K, C, C), 'bf16')))
        lib_fwd, lib_bwd, lib_err, lib_dtype = library_sampling(feat, pos, g)
        n = B * P * K * C
        m, a16 = check_pair(
            f'K6 deform_sample_cols level {H}x{W}', dk.deform_sample_cols,
            dk.deform_sample_cols_ref, [feat, pos],
            lambda a: [a[0].to(bf16), a[1]])
        one_launch(f'K6 deform_sample_cols level {H}x{W}', m)
        k6.append(entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_sample_cols, a16), 7 * n,
            'f32'), library_ms=lib_fwd))
        k3s.append(check_bwd(f'serial level {H}x{W}, uniform taps', feat,
                             pos, g, lib_bwd))
        pos = near_pos(H, W, K)
        _, near_bwd, _, _ = library_sampling(feat, pos, g)
        k3n.append(check_bwd(f'serial level {H}x{W}, taps near their pixel',
                             feat, pos, g, near_bwd))
        print(f'K6 / K3 yardstick F.grid_sample and its backward '
              f'({lib_dtype}, NCHW) level {H}x{W}: {lib_fwd:.4f} / '
              f'{lib_bwd:.4f} ms (backward with near taps {near_bwd:.4f}), '
              f'f32 max err vs plain {lib_err:.3e}', flush=True)
    # a level's two branches: 2 launches a level and forward or step
    results['deform_fused']['serial'] = merge(k1s, calls=2)
    results['deform_sample_cols'] = merge(k6, calls=2)
    results['deform_sample_bwd']['serial'] = merge(k3s, calls=2)
    results['deform_sample_bwd']['serial_near'] = merge(k3n, calls=2)
    # the parallel head's pts branch: kpt | rep weights side by side, F = 512
    H, W = SERIAL_LEVELS[0]
    feat, pos = randn(B, H, W, C), rand_pos(H, W, H * W, K)
    w = randn(K, C, 2 * C, std=(K * C) ** -0.5)
    m, a16 = check_pair(
        f'K1 deform_fused F=512 level {H}x{W}', dk.deform_conv_fused,
        dk.deform_conv_fused_ref, [feat, pos, w], cast)
    one_launch(f'K1 deform_fused F=512 level {H}x{W}', m)
    results['deform_fused']['f512_level0'] = entry(m, *bound(
        nbytes(*a16) + out_bytes(dk.deform_conv_fused, a16),
        k1_ops(H * W, K, C, 2 * C), 'bf16'))
    del feat, pos, w, g, a16

    def keeping(prepare, run):
        """K4, K5 or K8 through its prepared entry, the prepared weights kept
        per dtype as ResNet.prefix_weights keeps them on the main path: a
        call is then the kernel alone."""
        kept = {}

        def kernel(x, *ws):
            if x.dtype not in kept:
                kept[x.dtype] = prepare(*ws, x.dtype)
            return run(x, kept[x.dtype])
        return kernel

    def prepare_block(*a):
        return sk.prepare_block(dict(zip(sk.BLOCK_KEYS, a[:-1])), a[-1])

    # K4 on both canvas orientations (timed and bounded on the first)
    sw = randn(7, 7, 3, 64, std=(2.0 / 147) ** 0.5)
    sb = randn(64, std=0.1)
    k4 = []
    for hw in (CANVAS, CANVAS[::-1]):
        x = randn(B, *hw, 3)
        name = f'K4 stem_pool {hw[0]}x{hw[1]}'
        m, a16 = check_pair(
            name, keeping(sk.prepare_stem, sk.stem_pool_prepared),
            sk.stem_pool_ref, [x, sw, sb],
            lambda a: [a[0].to(torch.bfloat16), a[1], a[2]])
        one_launch(name, m)
        ops = 2 * B * (hw[0] // 2) * (hw[1] // 2) * 64 * 147
        k4.append(entry(m, *bound(
            nbytes(*a16) + out_bytes(sk.stem_pool, a16), ops, 'bf16')))
    results['stem_pool'] = k4[0]

    def tile_of(fn):
        """The bottleneck body one call of ``fn`` runs: 'fma' or the
        tensor-core body's tile, read off the kernel's name in a profile."""
        seen, tiles = {}, set()
        device_profile(fn, reps=2, names=seen)
        for n in seen['own']:
            m = re.search(r'bottleneck_mma_kernel<(\d+), ?(\d+)>', n)
            tiles.add(f'{m.group(1)}x{m.group(2)}' if m else 'fma')
        return ', '.join(sorted(tiles))

    # K5 for the three layer1 blocks at the stem output shape, and K8, the
    # per-block route's kernel, on the same inputs, both through their
    # prepared entries on weights kept per dtype in the layout they share
    H4, W4 = CANVAS[0] // 4, CANVAS[1] // 4
    k5, k8 = [], []
    for i, cin in enumerate((64, 256, 256)):
        x = torch.relu(randn(B, H4, W4, cin))
        blk = [randn(cin, 64, std=cin ** -0.5), randn(64, std=0.1),
               randn(3, 3, 64, 64, std=(9 * 64) ** -0.5), randn(64, std=0.1),
               randn(64, 256, std=64 ** -0.5), randn(256, std=0.1)]
        blk += ([randn(cin, 256, std=cin ** -0.5), randn(256, std=0.1)]
                if i == 0 else [None, None])
        name = f'K5 frozen_bottleneck block {i} (Cin {cin})'
        k5_kept = keeping(prepare_block, sk.frozen_bottleneck_prepared)
        m, a16 = check_pair(name, k5_kept, sk.frozen_bottleneck_ref,
                            [x] + blk, lambda a: [a[0].to(bf16)] + a[1:])
        one_launch(name, m)
        macs = cin * 64 + 9 * 64 * 64 + 64 * 256 + (cin * 256 if i == 0
                                                    else 0)
        k5.append(entry(m, *bound(
            nbytes(*[a for a in a16 if a is not None])
            + out_bytes(sk.frozen_bottleneck, a16),
            2 * B * H4 * W4 * macs, 'bf16')))
        name = f'K8 fused_bottleneck block {i} (Cin {cin})'
        k8_kept = keeping(prepare_block, rb.fused_bottleneck_prepared)
        m, a16 = check_pair(name, k8_kept, rb.bottleneck_reference, [x] + blk,
                            lambda a: [a[0].to(bf16)] + a[1:])
        one_launch(name, m)
        k8.append(entry(m, *bound(
            nbytes(*[a for a in a16 if a is not None])
            + out_bytes(rb.fused_bottleneck, a16),
            2 * B * H4 * W4 * macs, 'bf16')))
        # f32: each on its FMA body, within the f32 tolerance; bf16: one
        # tensor-core body, the same bits
        if not torch.allclose(k8_kept(x, *blk), k5_kept(x, *blk),
                              **F32_TOL):
            fail(f'K8 and K5 disagree on block {i} in f32')
        x16 = a16[0]
        if not torch.equal(k8_kept(x16, *blk), k5_kept(x16, *blk)):
            fail(f'K8 and K5 differ on block {i} in bf16')
        body = tile_of(lambda: k8_kept(x16, *blk))
        print(f'{name}: bf16 body {body}', flush=True)
        if body != '16x16':
            fail(f'{name} in bf16 ran {body}, not the 16x16 tensor-core body')
    results['frozen_bottleneck'] = merge(k5)
    results['fused_bottleneck'] = merge(k8)
    print('K8 agrees with K5 on the three layer1 blocks within the f32 '
          'tolerance in f32, and bit for bit in bf16', flush=True)
    # K8 at a width the tensor-core body takes on 8x16 tiles: layer2's
    # stride-1 block (512 -> 128 -> 512, identity) at layer1's map size
    x = torch.relu(randn(B, H4, W4, 512))
    blk = [randn(512, 128, std=512 ** -0.5), randn(128, std=0.1),
           randn(3, 3, 128, 128, std=(9 * 128) ** -0.5), randn(128, std=0.1),
           randn(128, 512, std=128 ** -0.5), randn(512, std=0.1), None, None]
    name = 'K8 fused_bottleneck width 128 (Cin 512, Cout 512)'
    k8_kept = keeping(prepare_block, rb.fused_bottleneck_prepared)
    m, a16 = check_pair(name, k8_kept, rb.bottleneck_reference, [x] + blk,
                        lambda a: [a[0].to(bf16)] + a[1:])
    one_launch(name, m)
    body = tile_of(lambda: k8_kept(a16[0], *blk))
    print(f'{name}: bf16 body {body}', flush=True)
    if body != '8x16':
        fail(f'{name} in bf16 ran {body}, not the 8x16 tensor-core body')
    macs = 512 * 128 + 9 * 128 * 128 + 128 * 512
    results['fused_bottleneck']['width128'] = entry(m, *bound(
        nbytes(*[a for a in a16 if a is not None])
        + out_bytes(rb.fused_bottleneck, a16), 2 * B * H4 * W4 * macs,
        'bf16'))
    del x, blk, a16
    for name, r in results.items():
        print(f'bound {name}: {r["bound_ms"]:.4f} ms by {r["bound_by"]} '
              f'(wrapper calls {r["ms"]:.4f} ms, kernel on the device '
              f'{r["device_ms"]:.4f} ms, per forward or step of batch {B})',
              flush=True)
        for case in ('near', 'serial', 'serial_near', 'width128'):
            if case in r:
                q = r[case]
                print(f'bound {name}, {case}: {q["bound_ms"]:.4f} ms by '
                      f'{q["bound_by"]} (wrapper calls {q["ms"]:.4f} ms, '
                      f'kernel on the device {q["device_ms"]:.4f} ms)',
                      flush=True)
    return results


def make_requests(n, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        img = rng.randint(0, 256, (B, *CANVAS, 3)).astype(np.uint8)
        # resized extents inside the canvas, as the loader pads them
        hw = np.array([[800, 1333], [800, 1067]], np.float32)
        sf = np.array([800 / 1200, 800 / 900], np.float32)
        reqs.append({'image': img, 'img_hw': hw, 'scale_factor': sf})
    return reqs


def wrappers():
    """The kernel wrappers of the port, by kernel name."""
    from kgdet_tpu_torch.ops.deform_kernels import (
        deform_conv_fused, deform_sample_bwd, deform_sample_cols,
        deform_sample_split)
    from kgdet_tpu_torch.ops.resblock import fused_bottleneck
    from kgdet_tpu_torch.ops.stem_kernels import frozen_bottleneck, stem_pool
    return {'deform_fused': deform_conv_fused,
            'deform_sample_split': deform_sample_split,
            'deform_sample_bwd': deform_sample_bwd, 'stem_pool': stem_pool,
            'frozen_bottleneck': frozen_bottleneck,
            'deform_sample_cols': deform_sample_cols,
            'fused_bottleneck': fused_bottleneck}


def launch_counts(**per_kernel):
    """Expected launches by kernel name, 0 for every kernel not named."""
    return {name: per_kernel.get(name, 0) for name in wrappers()}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in wrappers().items()}


def serve(torch, predict, reqs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = [predict(r) for r in reqs]
    torch.cuda.synchronize()
    return dets, time.perf_counter() - t0


def last_stage(outs):
    """The last stage's cls, kpt and bbox maps of every level."""
    return {f'{k} level {lvl}': o[k][-1] for lvl, o in enumerate(outs)
            for k in ('cls', 'kpt', 'bbox')}


def hold_against_plain(torch, model, batch, where=''):
    """The last-stage head outputs of ``model`` on ``batch``, on its kernels
    against on their plain versions: f32 within MODEL_F32_REL of each
    output's scale, bf16 within BF16_RATIO x the plain bf16 model's error
    from the f32 plain model."""
    from kgdet_tpu_torch.ops.image import device_normalize

    image = device_normalize(torch.as_tensor(batch['image']).cuda(),
                             torch.as_tensor(batch['img_hw']).cuda())
    dtype0 = model.dtype
    try:
        with torch.inference_mode():
            runs = {}
            for dtype in (torch.bfloat16, torch.float32):
                model.dtype = dtype
                for plain in (False, True):
                    model.use_plain_kernels(plain)
                    runs[dtype, plain] = last_stage(model(image))
    finally:
        model.dtype = dtype0
        model.use_plain_kernels(False)
    ref = runs[torch.float32, True]
    for k in ref:
        scale = max(1.0, ref[k].float().abs().max().item())
        e32 = max_err(runs[torch.float32, False][k], ref[k])
        ek = max_err(runs[torch.bfloat16, False][k], ref[k])
        ep = max_err(runs[torch.bfloat16, True][k], ref[k])
        print(f'{where}last stage {k}: f32 kernels vs plain {e32:.3e} (bound '
              f'{MODEL_F32_REL * scale:.3e}); bf16 vs f32 plain: kernels '
              f'{ek:.3e}, plain {ep:.3e} (bound {BF16_RATIO} x plain)',
              flush=True)
        if not e32 <= MODEL_F32_REL * scale:
            fail(f'{where}last stage {k}: f32 kernel model differs by '
                 f'{e32:.3e}')
        if not ek <= BF16_RATIO * ep:
            fail(f'{where}last stage {k}: bf16 kernel model err {ek:.3e} > '
                 f'{BF16_RATIO} x plain {ep:.3e}')


def phase_serving(torch, gpu, config, per_fwd, n_reqs=SERVED, compare=True):
    """Serve ``n_reqs`` requests through make_predict_fn on the config's
    model at full width; check the launch counts per forward and the
    detections; with ``compare``, hold the last-stage head outputs of the
    model on its kernels against the model on their plain versions."""
    from kgdet_tpu_torch.api import build_model, load_config, make_predict_fn

    cfg = load_config(config)
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, score_thr=0.0))
    print(f'serving: {os.path.relpath(config, ROOT)} ({cfg.head.type}, '
          f'strides {cfg.head.point_strides}), {cfg.compute_dtype}, canvas '
          f'{CANVAS[0]}x{CANVAS[1]}, batch {B}, random weights (seed {SEED}); '
          f'test.score_thr set to 0.0 so NMS has work under random weights',
          flush=True)
    model = build_model(cfg).init_weights(SEED).eval()
    if next(model.parameters()).device.type != 'cuda':
        fail('build_model did not place the model on the card')
    predict = make_predict_fn(model, cfg, CANVAS)
    reqs = make_requests(n_reqs, SEED)

    predict(reqs[0])                      # warm-up: cuDNN plans, allocator
    reset_launches()
    dets, secs = serve(torch, predict, reqs)
    got = read_launches()
    want = {k: v * len(reqs) for k, v in per_fwd.items()}
    if got != want:
        fail(f'launch counts {got} != {want} for {len(reqs)} forwards')
    launches = dict(got)
    n_valid = 0
    for d in dets:
        for k, v in d.items():
            if v.is_floating_point() and not torch.isfinite(v).all():
                fail(f'non-finite {k} in the served detections')
        if tuple(d['det_bboxes'].shape) != (B, cfg.test.max_per_img, 5) or \
                tuple(d['det_kpts'].shape) != \
                (B, cfg.test.max_per_img, 3 * cfg.head.num_keypts):
            fail(f'detection shapes {[tuple(v.shape) for v in d.values()]}')
        n_valid += int(d['valid'].sum())
    if n_valid == 0:
        fail('no detection survived NMS at score_thr 0')
    ips = B * len(reqs) / secs
    if not compare:
        print(f'serving: {len(reqs)} requests x {B} images, {n_valid} valid '
              f'detections, launches {launches}; {ips:.2f} img/s ({gpu})',
              flush=True)
        return model, cfg, reqs[0], launches

    model.use_plain_kernels(True)
    predict(reqs[0])
    _, psecs = serve(torch, predict, reqs)
    model.use_plain_kernels(False)
    pips = B * len(reqs) / psecs
    print(f'serving: {len(reqs)} requests x {B} images, {n_valid} valid '
          f'detections, launches {launches}; {ips:.2f} img/s with kernels, '
          f'{pips:.2f} img/s with plain versions ({gpu})', flush=True)

    # last-stage head outputs: kernels vs plain, bf16 and f32
    hold_against_plain(torch, model, reqs[0])
    return model, cfg, reqs[0], launches


def stage_times(prof, stages, span_device, steps):
    """From a profiler run: per stage its span (the labelled ranges on
    ``span_device``) and its device busy time (the kernels whose midpoint
    falls in one of its ranges), and per kernel name (ms, count); ms per
    step."""
    from collections import defaultdict

    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == span_device and e.name in stages]
    span_ms, busy_ms, kern = defaultdict(float), defaultdict(float), {}
    for s0, s1, name in spans:
        span_ms[name] += (s1 - s0) / 1e3 / steps
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in stages:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        mid = (e.time_range.start + e.time_range.end) / 2
        stage = next((n for s0, s1, n in spans if s0 <= mid <= s1), 'other')
        busy_ms[stage] += ms
        t, n = kern.get(e.name, (0.0, 0))
        kern[e.name] = (t + ms, n + 1)
    return span_ms, busy_ms, kern


def print_top_kernels(kern, steps, top):
    for name, (ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f'  {ms:8.3f} ms x{n // steps:<4d} {name[:96]}')


def short_name(kernel):
    """A kernel of the port as the profiler names it, without namespaces
    and arguments but with its template arguments (the tile or the dtype)."""
    return kernel.replace('(anonymous namespace)::', '').split('(')[0] \
        .split('::')[-1]


def print_own_kernels(kern, steps, per):
    print(f'  the port\'s kernels, device ms per {per}: ' + ', '.join(
        f'{short_name(name)} {ms:.3f} x{n // steps}'
        for name, (ms, n) in sorted(kern.items()) if 'kgdet::' in name),
        flush=True)


STAGES = ('normalize', 'backbone', 'neck', 'head', 'decode')


def phase_profile(torch, model, cfg, req, gpu, steps=2):
    """Where the time goes over `steps` served batches, stages labelled
    here around the calls into each layer: per stage its device span
    (first to last kernel, gaps included) and its busy time (the kernels
    in that span); per kernel its device time; the device's idle share of
    the wall time of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from kgdet_tpu_torch.models.families import get_head_family
    from kgdet_tpu_torch.ops.image import device_normalize

    canvas = tuple(req['image'].shape[1:3])
    decode = get_head_family(cfg.head.type).make_decode(cfg, canvas)
    img = torch.as_tensor(req['image']).cuda()
    img_hw = torch.as_tensor(req['img_hw']).cuda()
    sf = torch.as_tensor(req['scale_factor']).cuda()

    @torch.inference_mode()
    def run():
        with record_function('normalize'):
            x = device_normalize(img, img_hw)
        with record_function('backbone'):
            feats = model.backbone(x.to(model.dtype))
        with record_function('neck'):
            feats = model.neck(feats)
        with record_function('head'):
            outs = model.bbox_head(feats)
        with record_function('decode'):
            return decode(outs, img_hw, sf)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    span_ms, busy_ms, kern = stage_times(prof, STAGES, DeviceType.CUDA,
                                         steps)
    busy = sum(busy_ms.values())
    kind = 'plain versions' if model.backbone.plain_prefix else 'kernels'
    print(f'profile ({kind}): {steps} batches of {len(img)} at '
          f'{canvas[0]}x{canvas[1]} under torch.profiler: '
          f'{wall:.3f} ms per batch, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.3f} ({gpu})', flush=True)
    print('  stage device span / busy ms per batch: ' + ', '.join(
        f'{s} {span_ms[s]:.3f}/{busy_ms[s]:.3f}' for s in STAGES), flush=True)
    print_top_kernels(kern, steps, 8)
    print_own_kernels(kern, steps, 'batch')


def make_train_batches(n, seed, num_keypts):
    """Seeded synthetic training batches: uint8 images, 16 boxes an image
    with every keypoint visible, extents inside the canvas."""
    import numpy as np
    rng = np.random.RandomState(seed)
    G = 16
    batches = []
    for _ in range(n):
        boxes = np.zeros((B, G, 4), np.float32)
        boxes[..., :2] = rng.uniform(0, 300, (B, G, 2))
        boxes[..., 2:] = boxes[..., :2] + rng.uniform(64, 400, (B, G, 2))
        kpts = rng.uniform(0, 700, (B, G, num_keypts, 3)).astype(np.float32)
        kpts[..., 2] = 1
        batches.append({
            'image': rng.randint(0, 256, (B, *CANVAS, 3)).astype(np.uint8),
            'valid_hw': np.array([[800, 1333], [800, 1067]], np.int32),
            'gt_bboxes': boxes,
            'gt_labels': rng.randint(1, 14, (B, G)).astype(np.int32),
            'gt_kpts': kpts,
            'gt_mask': np.ones((B, G), bool),
        })
    return batches


def phase_function(torch, model, loss_fn, batch):
    """The autograd Function over K2 and K3 against the one over their plain
    versions, in f32, on the tensors that the train step's forward hands
    the two deformable stages (maps, RepPoints field, the stage's weights)
    and a seeded cotangent. No ReLU lies between the inputs and what is
    compared, so every output and every gradient is held to MODEL_F32_REL
    of its scale."""
    from kgdet_tpu_torch.models.kgdet_head import KpRepBlock
    from kgdet_tpu_torch.ops.deform import absolute_positions
    from kgdet_tpu_torch.ops.deform_kernels import deform_columns_dual

    blocks = {n: m for n, m in model.named_modules()
              if isinstance(m, KpRepBlock) and m.deform}
    caught = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=n: caught.__setitem__(
            n, [a.detach() for a in args])) for n, m in blocks.items()]
    model.dtype = torch.float32
    model.use_plain_kernels(False)
    with torch.no_grad():
        loss_fn(batch)
    for h in hooks:
        h.remove()
    if sorted(caught) != sorted(blocks) or len(blocks) != 2:
        fail(f'the forward ran deformable stages {sorted(caught)} of '
             f'{sorted(blocks)}')
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    names = ('cls_cat', 'kpt_cat', 'grad cls_feat', 'grad pts_feat',
             'grad pos')
    for n, blk in blocks.items():
        cls_feat, pts_feat, field = caught[n]
        Bn, H, W, _ = cls_feat.shape
        taps = blk.column_taps
        pos = absolute_positions(field.reshape(Bn, H, W, sum(taps), 2), H, W)
        weights = [w.detach() for br in ('cls', 'keypts')
                   for w in blk.dfm_weights(br, cls_feat.dtype)]
        cots = [torch.randn((Bn, H * W, sum(w.shape[-1] for w in
                                            weights[:len(taps)])),
                            device='cuda', generator=gen) for _ in range(2)]

        def run(plain):
            leaves = [t.clone().requires_grad_()
                      for t in (cls_feat, pts_feat, pos, *weights)]
            outs = deform_columns_dual(
                leaves[0], leaves[1], leaves[2], leaves[3:3 + len(taps)],
                leaves[3 + len(taps):], taps, plain=plain)
            return [*outs, *torch.autograd.grad(outs, leaves, cots)]
        got, want = run(False), run(True)
        errs = [max_err(g, w) / w.abs().max().item()
                for g, w in zip(got, want)]
        labels = names + tuple(f'grad weight {i}' for i in range(len(weights)))
        worst = max(zip(errs, labels))
        print(f'Function over K2+K3 vs plain on the train step\'s tensors, '
              f'f32, {n} (map {H}x{W}, {sum(taps)} taps): worst of '
              f'{len(errs)} outputs and gradients {worst[0]:.3e} of its '
              f'scale ({worst[1]}; bound {MODEL_F32_REL}; grad_feat by f32 '
              f'atomics)', flush=True)
        if not all(e <= MODEL_F32_REL for e in errs):
            fail(f'f32: the Function over K2 and K3 differs from the one '
                 f'over their plain versions in {n}: '
                 + ', '.join(f'{lb} {e:.3e}' for e, lb in zip(errs, labels)))


GRAD_GROUPS = ('bbox_head.kp_rep_block_2.', 'bbox_head.kp_rep_block_3.',
               'backbone.layer4.')


def take_train_steps(torch, gpu, config, per_step, n_logs, free_name):
    """init_trainer on the config, one warm-up and TRAIN_STEPS timed steps of
    make_train_step on seeded synthetic batches: checks the launch counts
    per step, finite logs (``n_logs`` of them), a frozen parameter bit-equal
    and ``free_name`` moved. Returns (model, cfg, optimizer, batches,
    launches)."""
    from kgdet_tpu_torch.api import init_trainer, load_config
    from kgdet_tpu_torch.parallel.train import frozen_param_mask

    cfg = load_config(config)
    model, optimizer, train_step = init_trainer(cfg, CANVAS,
                                                steps_per_epoch=1000)
    params = dict(model.named_parameters())
    if next(iter(params.values())).device.type != 'cuda':
        fail('init_trainer did not place the model on the card')
    batches = make_train_batches(1 + TRAIN_STEPS, SEED + 1,
                                 cfg.head.num_keypts)
    frozen = frozen_param_mask(model, cfg.backbone.frozen_stages)
    frozen_name = 'backbone.layer1.0.conv1.weight'
    if not frozen[frozen_name] or frozen[free_name]:
        fail('frozen_param_mask does not split layer1 from the head')
    start = {n: params[n].detach().clone() for n in (frozen_name, free_name)}

    torch.cuda.reset_peak_memory_stats()
    logs = [train_step(batches[0])]         # warm-up: cuDNN plans, allocator
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs += [train_step(b) for b in batches[1:]]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = read_launches()
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if got != want:
        fail(f'launch counts {got} != {want} for {TRAIN_STEPS} train steps')
    peak = torch.cuda.max_memory_allocated()
    for i, lg in enumerate(logs):
        vals = {k: v.item() for k, v in lg.items()}
        if len(vals) != n_logs or not all(v == v and abs(v) != float('inf')
                                          for v in vals.values()):
            fail(f'train step {i}: logs {vals}')
        print(f'train step {i}: loss {vals["loss"]:.4f} grad_norm '
              f'{vals["grad_norm"]:.4f} ' + ' '.join(
                  f'{k} {v:.0f}' for k, v in vals.items()
                  if k.startswith('num_pos')), flush=True)
    if not torch.equal(params[frozen_name].detach(), start[frozen_name]):
        fail(f'frozen parameter {frozen_name} changed')
    if torch.equal(params[free_name].detach(), start[free_name]):
        fail(f'free parameter {free_name} did not move')
    ms = secs / TRAIN_STEPS * 1e3
    print(f'training: {os.path.relpath(config, ROOT)}, {TRAIN_STEPS} steps x '
          f'{B} images, {cfg.compute_dtype}, canvas {CANVAS[0]}x{CANVAS[1]}, '
          f'launches {got}; {ms:.2f} ms per step, '
          f'{B * TRAIN_STEPS / secs:.2f} img/s, peak memory '
          f'{peak / 2 ** 30:.3f} GiB ({gpu})', flush=True)
    return model, cfg, optimizer, batches, got


def loss_and_grads(model, optimizer, loss_fn, groups, dtype, plain, batch,
                   plain_prefix=None):
    """(loss, {name: f32 gradient} of the parameters under ``groups``) of
    one batch, the model computing in ``dtype`` on its kernels or (``plain``)
    their plain versions; ``plain_prefix`` overrides that for the frozen
    prefix alone."""
    model.dtype = dtype
    model.use_plain_kernels(plain)
    if plain_prefix is not None:
        model.backbone.plain_prefix = plain_prefix
    optimizer.zero_grad()
    total, _ = loss_fn(batch)
    total.backward()
    return total.item(), {n: p.grad.float().clone()
                          for n, p in model.named_parameters()
                          if n.startswith(groups) and p.grad is not None}


def worst_and_share(run, against):
    """Over the parameters: the largest difference relative to the
    gradient's scale, and the share of all their elements that differ by
    more than MODEL_F32_REL of their parameter's scale."""
    worst, beyond, total = (0.0, ''), 0, 0
    for n, want in against[1].items():
        diff = (run[1][n] - want).abs() / want.abs().max()
        worst = max(worst, (diff.max().item(), n))
        beyond += (diff > MODEL_F32_REL).sum().item()
        total += diff.numel()
    return worst, beyond / total


def check_same_prefix_grads(what, kern32, head32):
    """f32, the model on its sampling kernels against the model on their
    plain versions, the frozen prefix the same on both sides: the loss
    within MODEL_F32_REL, every gradient element within MODEL_GRAD_REL and
    all but MODEL_FLIP_SHARE of them within MODEL_F32_REL of its scale."""
    w_head, flips = worst_and_share(kern32, head32)
    print(f'gradients f32, {what} vs their plain versions on the same '
          f'prefix: loss {kern32[0]:.6f} vs {head32[0]:.6f}; worst of '
          f'{len(head32[1])} parameters {w_head[0]:.3e} of its scale '
          f'({w_head[1]}; bound {MODEL_GRAD_REL}); share of their elements '
          f'beyond {MODEL_F32_REL}: {flips:.3e} (bound {MODEL_FLIP_SHARE})',
          flush=True)
    if not abs(kern32[0] - head32[0]) <= MODEL_F32_REL * abs(head32[0]) \
            or not w_head[0] <= MODEL_GRAD_REL \
            or not flips <= MODEL_FLIP_SHARE:
        fail(f'f32: the model on {what} differs from the model on their '
             'plain versions')


def check_bf16_grads(ref_loss, ref, kern16, plain16, groups):
    """bf16 against the f32 plain model: the kernel model's loss error and,
    per parameter group, relative L2 gradient error at most BF16_RATIO x the
    plain model's."""
    (k16_loss, k16), (p16_loss, p16) = kern16, plain16
    # one bf16 rounding of the loss is the least either can be held to
    loss_floor = 2.0 ** -8 * abs(ref_loss)
    ek, ep = abs(k16_loss - ref_loss), abs(p16_loss - ref_loss)
    print(f'loss bf16 vs f32 plain {ref_loss:.4f}: kernels {ek:.3e}, plain '
          f'{ep:.3e}', flush=True)
    if not ek <= max(BF16_RATIO * ep, loss_floor):
        fail(f'bf16 kernel model: loss err {ek:.3e} > {BF16_RATIO} x {ep:.3e}')
    for group in groups:
        names = [n for n in ref if n.startswith(group)]

        def rel_err(run):
            num = sum((run[n] - ref[n]).square().sum() for n in names)
            return (num / sum(ref[n].square().sum() for n in names)) \
                .sqrt().item()
        ek, ep = rel_err(k16), rel_err(p16)
        print(f'gradients bf16 vs f32 plain, {group}* ({len(names)} '
              f'parameters), relative L2 error: kernels {ek:.3e}, plain '
              f'{ep:.3e} (bound {BF16_RATIO} x plain)', flush=True)
        if not ek <= BF16_RATIO * ep:
            fail(f'bf16 kernel model: gradients of {group}* err {ek:.3e} > '
                 f'{BF16_RATIO} x plain {ep:.3e}')


def phase_training(torch, gpu):
    from kgdet_tpu_torch.parallel.train import make_loss_fn

    model, cfg, optimizer, batches, got = take_train_steps(
        torch, gpu, CONFIG, launch_counts(
            deform_sample_split=2, deform_sample_bwd=2, stem_pool=1,
            frozen_bottleneck=3),
        n_logs=12, free_name='bbox_head.kp_rep_block_3.cls_out.weight')

    # loss and gradients on one batch: kernels vs plain versions
    loss_fn = make_loss_fn(model, cfg, CANVAS)

    def run(dtype, plain, plain_prefix=None, batch=batches[0]):
        return loss_and_grads(model, optimizer, loss_fn, GRAD_GROUPS, dtype,
                              plain, batch, plain_prefix)

    def worst_of(run, against):
        return max((max_err(run[1][n], against[1][n])
                    / against[1][n].abs().max().item(), n)
                   for n in against[1])

    f32 = torch.float32
    ref_loss, ref = plain32 = run(f32, True)
    kern32 = run(f32, False)
    phase_function(torch, model, loss_fn, batches[0])
    # K2 and K3 in the model: the plain head on the same (kernel) prefix
    check_same_prefix_grads('K2+K3', kern32, run(f32, True,
                                                 plain_prefix=False))
    # all kernels vs all plain: K4 and K5 round their f32 sums in another
    # order (1e-6), and this model's gradients amplify that: shown by the
    # plain model's own change under one bit of one input pixel
    w_all = worst_of(kern32, plain32)
    nudged = dict(batches[0], image=batches[0]['image'].copy())
    nudged['image'][0, 50, 50, 0] ^= 1
    w_sens = worst_of(run(f32, True, batch=nudged), plain32)
    print(f'gradients f32, all kernels vs all plain: loss {kern32[0]:.6f} vs '
          f'{ref_loss:.6f}; worst {w_all[0]:.3e} of its scale ({w_all[1]}; '
          f'bound {MODEL_GRAD_REL}); for scale, the plain model with one '
          f'input pixel changed by 1/255: worst {w_sens[0]:.3e} '
          f'({w_sens[1]})', flush=True)
    if not abs(kern32[0] - ref_loss) <= MODEL_F32_REL * abs(ref_loss) \
            or not w_all[0] <= MODEL_GRAD_REL:
        fail('f32 kernel model: loss or a gradient differs from the plain '
             'model')
    plain16 = run(torch.bfloat16, True)
    check_bf16_grads(ref_loss, ref, run(torch.bfloat16, False), plain16,
                     GRAD_GROUPS)
    optimizer.zero_grad()
    model.dtype = torch.bfloat16
    model.use_plain_kernels(False)
    return model, cfg, optimizer, batches[0], got


SERIAL_GRAD_GROUPS = ('bbox_head.', 'neck.', 'backbone.layer4.')


def phase_serial_function(torch, model, loss_fn, batch):
    """The autograd Function of deform_conv_fused over K6 and K3 against the
    one over their plain versions, in f32, on the tensors that the train
    step's forward hands the stride-8 and the stride-32 level (both
    branches: map, tap positions, weight) and a seeded cotangent. No ReLU
    lies between the inputs and what is compared, so the output and every
    gradient are held to MODEL_F32_REL of their scale."""
    import kgdet_tpu_torch.models.serial_head as serial_head
    from kgdet_tpu_torch.ops.deform_kernels import deform_conv_fused

    calls = []

    def record(feat, pos, weight, plain=False):
        calls.append((feat.detach(), pos.detach(), weight.detach()))
        return deform_conv_fused(feat, pos, weight, plain=plain)

    model.dtype = torch.float32
    model.use_plain_kernels(False)
    serial_head.deform_conv_fused = record
    try:
        with torch.no_grad():
            loss_fn(batch)
    finally:
        serial_head.deform_conv_fused = deform_conv_fused
    strides = model.bbox_head.point_strides
    if len(calls) != 2 * len(strides):
        fail(f'the forward made {len(calls)} deformable convs over '
             f'{len(strides)} levels')
    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    names = ('output', 'grad map', 'grad positions', 'grad weight')
    for lvl in (strides.index(8), strides.index(32)):
        for branch, (feat, pos, weight) in zip(('cls', 'pts'),
                                               calls[2 * lvl:2 * lvl + 2]):
            ct = torch.randn((*pos.shape[:2], weight.shape[-1]),
                             device='cuda', generator=gen)

            def run(plain):
                leaves = [t.clone().requires_grad_()
                          for t in (feat, pos, weight)]
                out = deform_conv_fused(*leaves, plain=plain)
                return [out, *torch.autograd.grad(out, leaves, ct)]
            got, want = run(False), run(True)
            errs = [max_err(g, w) / w.abs().max().item()
                    for g, w in zip(got, want)]
            worst = max(zip(errs, names))
            print(f'Function over K6+K3 vs plain on the train step\'s '
                  f'tensors, f32, stride {strides[lvl]} {branch} branch (map '
                  f'{feat.shape[1]}x{feat.shape[2]}, F {weight.shape[-1]}): '
                  f'worst {worst[0]:.3e} of its scale ({worst[1]}; bound '
                  f'{MODEL_F32_REL}; grad map by f32 atomics)', flush=True)
            if not all(e <= MODEL_F32_REL for e in errs):
                fail('f32: the Function over K6 and K3 differs from the one '
                     f'over their plain versions at stride {strides[lvl]}: '
                     + ', '.join(f'{n} {e:.3e}' for e, n in zip(errs, names)))


def phase_serial_training(torch, gpu):
    from kgdet_tpu_torch.parallel.train import make_loss_fn

    n_levels = len(SERIAL_LEVELS)
    model, cfg, optimizer, batches, got = take_train_steps(
        torch, gpu, SERIAL_CONFIG, launch_counts(
            deform_sample_cols=2 * n_levels, deform_sample_bwd=2 * n_levels,
            stem_pool=1, frozen_bottleneck=3),
        n_logs=5 * n_levels + 4,
        free_name='bbox_head.keypts_refine_out.weight')
    loss_fn = make_loss_fn(model, cfg, CANVAS)

    def run(dtype, plain):
        # the prefix stays on K4 and K5 on both sides: the candidate boxes,
        # and so the refine targets, are then the same
        return loss_and_grads(model, optimizer, loss_fn, SERIAL_GRAD_GROUPS,
                              dtype, plain, batches[0], plain_prefix=False)

    f32 = torch.float32
    phase_serial_function(torch, model, loss_fn, batches[0])
    ref_loss, ref = head32 = run(f32, True)
    check_same_prefix_grads('K6+K3', run(f32, False), head32)
    plain16 = run(torch.bfloat16, True)
    check_bf16_grads(ref_loss, ref, run(torch.bfloat16, False), plain16,
                     SERIAL_GRAD_GROUPS)
    optimizer.zero_grad()
    model.dtype = torch.bfloat16
    model.use_plain_kernels(False)
    return model, cfg, optimizer, batches[0], got


def phase_per_block_backbone(torch, model, req, gpu):
    """The backbone with the frozen layer1 run block by block (K8) in place
    of the K4+K5 chain: launch counts, the C2 output against the chain's and
    against the all-plain route's in f32 and bf16, the chain's own bf16
    error, and the frozen prefix's time on both routes. And what each route
    puts on the device once its weights are kept: the per-block route K8's
    16x16 tensor-core body x3 beside PyTorch's stem, the served chain K4 and
    K5 x3 and nothing else."""
    from kgdet_tpu_torch.ops.image import device_normalize

    backbone = model.backbone
    image = device_normalize(torch.as_tensor(req['image']).cuda(),
                             torch.as_tensor(req['img_hw']).cuda())

    def c2(dtype, per_block, plain):
        backbone.prefix_pipeline = not per_block
        backbone.plain_prefix = plain
        with torch.inference_mode():
            return backbone(image.to(dtype))[0]

    try:
        reset_launches()
        k16 = c2(torch.bfloat16, True, False)
        got = read_launches()
        want = launch_counts(fused_bottleneck=3)
        if got != want:
            fail(f'per-block backbone: launch counts {got} != {want}')
        ref = c2(torch.float32, True, True)
        scale = ref.abs().max().item()
        e_chain = max_err(c2(torch.float32, True, False),
                          c2(torch.float32, False, False))
        e_plain = max_err(c2(torch.float32, True, False), ref)
        ek, ep = max_err(k16, ref), max_err(c2(torch.bfloat16, True, True),
                                            ref)
        ec = max_err(c2(torch.bfloat16, False, False), ref)
        epc = max_err(c2(torch.bfloat16, False, True), ref)
        x16 = image.to(torch.bfloat16)
        times = {}
        for per_block in (False, True, True, False):
            backbone.prefix_pipeline = not per_block
            backbone.plain_prefix = False
            times.setdefault(per_block, []).append(
                median_ms(lambda: backbone.frozen_prefix(x16), reps=10))
        with torch.inference_mode():
            backbone.prefix_pipeline = False
            pb_names = {}
            pb_ms, pb_dev, pb_own = device_profile(
                lambda: backbone.frozen_prefix(x16), names=pb_names)
            backbone.prefix_pipeline = True
            chain_names = {}
            prefix_ms, n_dev, n_own = device_profile(
                lambda: backbone.frozen_prefix(x16), names=chain_names)
    finally:
        backbone.prefix_pipeline = True
        backbone.plain_prefix = False
    print(f'per-block backbone (K8 x3, stem and maxpool by PyTorch), C2 of '
          f'{tuple(k16.shape)}: f32 vs the K4+K5 chain {e_chain:.3e}, vs the '
          f'all-plain route {e_plain:.3e} (bound {MODEL_F32_REL * scale:.3e});'
          f' bf16 vs f32 plain: K8 route {ek:.3e}, plain route {ep:.3e}, '
          f'chain {ec:.3e}, plain chain {epc:.3e} (bound {BF16_RATIO} x '
          f'plain); frozen prefix bf16 median ms: per block '
          f'{min(times[True]):.4f}, chain {min(times[False]):.4f}; on '
          f'their kept weights, a forward puts on the device: per block '
          f'{pb_dev:g} activities, {pb_names["device_ms"]:.4f} ms, of '
          f'which K8 {pb_own:g} launches, {pb_ms:.4f} ms ({pb_names["own"]});'
          f' chain {n_dev:g} activities, {chain_names["device_ms"]:.4f} ms, '
          f'of '
          f'which the port\'s kernels {n_own:g}, {prefix_ms:.4f} ms '
          f'({gpu})', flush=True)
    if not max(e_chain, e_plain) <= MODEL_F32_REL * scale:
        fail('f32: the per-block backbone differs from the chain or the '
             'plain route')
    if not ek <= BF16_RATIO * ep:
        fail(f'bf16: per-block backbone err {ek:.3e} > {BF16_RATIO} x plain '
             f'{ep:.3e}')
    if not ec <= BF16_RATIO * epc:
        fail(f'bf16: K4+K5 chain err {ec:.3e} > {BF16_RATIO} x the plain '
             f'chain\'s {epc:.3e}')
    if pb_own != 3 or not all(re.search(r'bottleneck_mma_kernel<16, ?16>', n)
                              for n in pb_names['own']):
        fail(f'the per-block frozen prefix ran {pb_names["own"]} x '
             f'{pb_own:g}, not K8\'s 16x16 tensor-core body x3')
    if n_dev != 4 or n_own != 4:
        fail(f'the served frozen prefix put {n_dev:g} activities on the '
             f'device, {n_own:g} of them the port\'s kernels, not K4 and K5 '
             f'x3 alone')
    return got


TRAIN_STAGES = ('normalize', 'fwd_backbone', 'fwd_neck', 'fwd_head',
                'loss_targets', 'backward', 'optimizer')


def phase_train_profile(torch, model, cfg, optimizer, batch, gpu, steps=2):
    """The train step by stage. Each stage ends in a synchronize inside its
    labelled range, so every kernel falls into the host range of its stage
    (the backward's kernels are launched from the autograd thread): per
    stage the host span (launch overhead included) and the device busy time.
    The idle share of a step is taken against an unprofiled, unsynchronized
    run of the same stages."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from kgdet_tpu_torch.ops.image import device_normalize
    from kgdet_tpu_torch.parallel.train import (
        BATCH_KEYS, batch_valid_flags, build_level_geometry, compute_loss)

    feed = {k: torch.as_tensor(batch[k]).cuda() for k in BATCH_KEYS}
    grids = build_level_geometry(cfg, CANVAS, device='cuda')

    stage = record_function

    def run(sync):
        optimizer.zero_grad()
        with stage('normalize'):
            x = device_normalize(feed['image'], feed['valid_hw'])
            sync()
        with stage('fwd_backbone'):
            feats = model.backbone(x.to(model.dtype))
            sync()
        with stage('fwd_neck'):
            feats = model.neck(feats)
            sync()
        with stage('fwd_head'):
            outs = model.bbox_head(feats)
            sync()
        with stage('loss_targets'):
            valids = batch_valid_flags(cfg, CANVAS, feed['valid_hw'])
            total, _ = compute_loss(outs, grids, valids, feed, cfg,
                                    canvas_hw=CANVAS)
            sync()
        with stage('backward'):
            total.backward()
            sync()
        with stage('optimizer'):
            optimizer.step()
            sync()

    run(torch.cuda.synchronize)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run(lambda: None)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run(torch.cuda.synchronize)
    span_ms, busy_ms, kern = stage_times(prof, TRAIN_STAGES, DeviceType.CPU,
                                         steps)
    busy = sum(busy_ms.values())
    if busy <= 0:
        fail('the profiler saw no device time in the train step')
    print(f'train profile: {steps} steps of {B}: {wall:.3f} ms per step '
          f'unprofiled, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.3f} ({gpu})', flush=True)
    print('  stage host span (synchronized) / device busy ms per step: '
          + ', '.join(f'{s} {span_ms[s]:.3f}/{busy_ms[s]:.3f}'
                      for s in TRAIN_STAGES + ('other',)), flush=True)
    print_top_kernels(kern, steps, 10)
    print_own_kernels(kern, steps, 'step')


# ------------------------------------------------------------ phase 9: eval
# 24 batches of 8, 12 on each canvas: a window of inference and evaluation
# long enough that setup and the first calls do not set the rate
EVAL_IMAGES = 192
# (height, width) of the landscape images, in turn; the portrait ones are
# these transposed. One in eight is exactly the 1333 x 800 scale, the rest
# need a resize. The first 16 images hold every size in both orientations
EVAL_SIZES = ((800, 1333), (600, 900), (480, 640), (720, 1280),
              (1000, 1500), (375, 500), (768, 1024), (900, 1200))
# two landscape and two portrait images, batches of 2 (the grouped loader,
# as the JAX package's, cannot wrap-pad a group of fewer than half a batch)
TTA_IMAGES = 4
# the configured scale, half of it (inside the canvas buckets) and one
# beyond every bucket (its canvas and predict function made on first use)
TTA_SCALES = ('1333', '800', '667', '400', '1600', '960')


def write_png(path, bgr):
    """(H, W, 3) uint8 BGR -> an 8-bit RGB PNG, rows filtered None / Sub /
    Up in turn (NumPy and zlib, so that the phase needs no OpenCV)."""
    import struct
    import zlib

    import numpy as np

    rgb = np.ascontiguousarray(bgr[..., ::-1]).reshape(bgr.shape[0], -1)
    rows, prev = [], np.zeros(rgb.shape[1], np.uint8)
    for y, line in enumerate(rgb):
        kind = y % 3
        if kind == 1:
            line_f = line - np.concatenate([np.zeros(3, np.uint8), line[:-3]])
        elif kind == 2:
            line_f = line - prev
        else:
            line_f = line
        rows.append(bytes([kind]) + line_f.tobytes())
        prev = line

    def chunk(kind, body):
        return (struct.pack('>I', len(body)) + kind + body +
                struct.pack('>I', zlib.crc32(kind + body) & 0xFFFFFFFF))
    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack(
            '>IIBBBBB', bgr.shape[1], bgr.shape[0], 8, 2, 0, 0, 0)) +
            chunk(b'IDAT', zlib.compress(b''.join(rows), 1)) +
            chunk(b'IEND', b''))


def make_eval_set(root, seed):
    """A DeepFashion2-style validation set under ``root``:
    validation-coco_style.json and validation/image/*.png, EVAL_IMAGES
    images (half landscape, half portrait, EVAL_SIZES), 1 to 3 garments an
    image with keypoints in their class's slice of the 294 and
    num_keypoints, and a crowd region in every fourth image. The images are
    smooth colour ramps with the garments as flat boxes and a little
    noise."""
    import numpy as np

    from kgdet_tpu_torch.data.deepfashion2_meta import (
        CLASS_KEYPOINT_RANGES, NUM_KEYPOINTS)

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, 'validation', 'image')
    os.makedirs(img_dir)
    images, anns = [], []
    for i in range(EVAL_IMAGES):
        h, w = EVAL_SIZES[i // 2 % len(EVAL_SIZES)]
        if i % 2:
            h, w = w, h
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 255 // w, yy * 255 // h,
                        (xx + yy) * 255 // (h + w)], -1).astype(np.int32)
        name = f'{i + 1:06d}.png'
        images.append({'id': i + 1, 'file_name': name, 'height': h,
                       'width': w})
        for _ in range(rng.randint(1, 4)):
            bw, bh = rng.randint(w // 6, w // 2), rng.randint(h // 6, h // 2)
            x0, y0 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            img[y0:y0 + bh, x0:x0 + bw] = rng.randint(0, 256, 3)
            cat = int(rng.randint(1, 14))
            s, e = CLASS_KEYPOINT_RANGES[cat]
            kp = np.zeros((NUM_KEYPOINTS, 3))
            kp[s:e, 0] = rng.uniform(x0, x0 + bw, e - s).round(1)
            kp[s:e, 1] = rng.uniform(y0, y0 + bh, e - s).round(1)
            kp[s:e, 2] = rng.choice([0, 1, 2], e - s, p=[0.2, 0.4, 0.4])
            anns.append({'id': len(anns) + 1, 'image_id': i + 1,
                         'category_id': cat, 'iscrowd': 0,
                         'bbox': [float(x0), float(y0), float(bw),
                                  float(bh)], 'area': float(bw * bh),
                         'keypoints': kp.reshape(-1).tolist(),
                         'num_keypoints': int((kp[:, 2] > 0).sum())})
        if i % 4 == 0:
            anns.append({'id': len(anns) + 1, 'image_id': i + 1,
                         'category_id': int(rng.randint(1, 14)),
                         'iscrowd': 1, 'bbox': [0.0, 0.0, w / 4, h / 4],
                         'area': w * h / 16, 'num_keypoints': 0,
                         'keypoints': [0.0] * 3 * NUM_KEYPOINTS})
        img += rng.randint(-4, 5, img.shape)
        write_png(os.path.join(img_dir, name),
                  np.clip(img, 0, 255).astype(np.uint8))
    cats = [{'id': c, 'name': f'cls{c}'} for c in range(1, 14)]
    with open(os.path.join(root, 'validation-coco_style.json'), 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': cats}, f)
    return images, anns


def eval_config(root, name):
    """CONFIG with its data root at ``root`` and test.score_thr 0.0 (so the
    evaluation has detections to score under random weights)."""
    with open(CONFIG) as f:
        text = f.read()
    if "_DATA_ROOT = '/data/deepfashion2'" not in text:
        fail('the cascade config no longer sets _DATA_ROOT')
    text = text.replace("_DATA_ROOT = '/data/deepfashion2'",
                        f'_DATA_ROOT = {root!r}')
    text += ('\nimport dataclasses\nconfig = config.replace(test='
             'dataclasses.replace(config.test, score_thr=0.0))\n')
    path = os.path.join(root, name)
    with open(path, 'w') as f:
        f.write(text)
    return path


def run_cli(argv):
    """tools/test.py's main in this process; returns its result and what
    it printed (echoed here)."""
    import contextlib
    import io

    from kgdet_tpu_torch.tools import test as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    print(buf.getvalue(), end='', flush=True)
    return out, buf.getvalue()


def copypaste(printed, iou_type, n):
    import math
    lines = [ln for ln in printed.splitlines()
             if ln.startswith(f'{iou_type}_mAP_copypaste: ')]
    if len(lines) != 1:
        fail(f'{len(lines)} {iou_type}_mAP_copypaste lines')
    vals = [float(v) for v in lines[0].split(': ', 1)[1].split()]
    if len(vals) != n or not all(math.isfinite(v) for v in vals):
        fail(f'{iou_type}_mAP_copypaste: {vals}, want {n} finite numbers')
    return vals


def phase_eval(torch, gpu, per_fwd):
    """The evaluation path at full width: a synthetic DeepFashion2-style
    validation set as PNGs, the evaluator on its own ground truth, the
    model on its kernels against on their plain versions at batch 8 on both
    canvases, the CLI tools/test.py in-process (launch counts per batch,
    both JSON files, the copypaste lines), run_inference against a direct
    predict call, and multi-scale / flip TTA on a subset."""
    import shutil
    import tempfile

    import numpy as np

    from kgdet_tpu_torch.api import init_detector, make_predict_fn
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.data import image_io
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.data.loader import DataLoader
    from kgdet_tpu_torch.eval_loop import evaluate_results, run_inference

    root = tempfile.mkdtemp(prefix='kgdet_eval_')
    try:
        t0 = time.perf_counter()
        images, anns = make_eval_set(root, SEED)
        cfg_path = eval_config(root, 'eval_cfg.py')
        cfg = load_config(cfg_path)
        data = cfg.val_data
        print(f'eval: {len(images)} PNG images '
              f'({sum(im["width"] > im["height"] for im in images)} '
              f'landscape), {len(anns)} annotations '
              f'({sum(a["iscrowd"] for a in anns)} crowd) written in '
              f'{time.perf_counter() - t0:.1f} s; image_io backend '
              f'{image_io.BACKEND}; val_data batch {data.batch_size}, '
              f'canvases {data.canvas_hw}, img_scale {data.img_scale}; '
              f'test.score_thr set to 0.0', flush=True)
        dataset = DeepFashion2Dataset(data, train=False)

        # the evaluator on its own ground truth: all-area AP 1
        gt = {}
        for a in anns:
            if a['iscrowd']:
                continue
            x, y, w, h = a['bbox']
            gt.setdefault(a['image_id'], []).append(
                ([x, y, x + w - 1, y + h - 1, 1.0],
                 dataset.cat_ids.index(a['category_id']), a['keypoints']))
        results = {i: (np.asarray([g[0] for g in v], np.float32),
                       np.asarray([g[1] for g in v]),
                       np.asarray([g[2] for g in v], np.float32))
                   for i, v in gt.items()}
        stats, _ = evaluate_results(results, dataset,
                                    os.path.join(root, 'gt'), verbose=False)
        print(f'eval: ground truth as detections, all-area AP bbox '
              f'{stats["bbox"]["AP"]:.4f}, keypoints '
              f'{stats["keypoints"]["AP"]:.4f}', flush=True)
        for k in ('bbox', 'keypoints'):
            if stats[k]['AP'] != 1.0:
                fail(f'ground truth as detections: {k} AP {stats[k]}')

        # host data alone: read, resize, pad, collate, one thread; the
        # first batch of each canvas kept
        t0 = time.perf_counter()
        firsts, n_batches_data = {}, 0
        for batch in DataLoader(dataset, data.batch_size, train=False,
                                num_workers=0):
            firsts.setdefault(tuple(batch['image'].shape[1:3]), batch)
            n_batches_data += 1
        data_ms = 1e3 * (time.perf_counter() - t0) / n_batches_data
        if sorted(firsts) != sorted(map(tuple, data.canvas_hw)):
            fail(f'batch canvases {sorted(firsts)}, want both of '
                 f'{data.canvas_hw}')
        img_ms = own_ms = 1e3 * (time.perf_counter() - t0) / len(dataset)
        if image_io.cv2 is not None:
            # the port's own PNG reader and resize (what runs where OpenCV
            # is absent) on the first 16 images, every size in both
            # orientations: the same samples, bit for bit
            n = min(16, len(dataset))
            t0 = time.perf_counter()
            ref = [dataset.prepare_test(i) for i in range(n)]
            img_ms = 1e3 * (time.perf_counter() - t0) / n
            opencv, image_io.cv2 = image_io.cv2, None
            try:
                t0 = time.perf_counter()
                own = [dataset.prepare_test(i) for i in range(n)]
                own_ms = 1e3 * (time.perf_counter() - t0) / n
            finally:
                image_io.cv2 = opencv
            for i, (a, b) in enumerate(zip(ref, own)):
                for k in a:
                    if not np.array_equal(a[k], b[k]):
                        fail(f'the NumPy image path differs from cv2 '
                             f'{opencv.__version__} in {k} of sample {i}')
            print(f'eval: the NumPy image path gives the samples of cv2 '
                  f'{opencv.__version__} bit for bit on {n} images; an '
                  f'image: {img_ms:.1f} ms with cv2, {own_ms:.1f} ms with '
                  f'NumPy', flush=True)

        # the model on its kernels against on their plain versions, on the
        # first batch of 8 of each canvas
        model = init_detector(cfg).model
        for (h, w), batch in sorted(firsts.items()):
            hold_against_plain(torch, model, batch,
                               f'eval batch {data.batch_size} {h}x{w}: ')

        # the CLI, in-process, on the card
        prefix = os.path.join(root, 'results')
        torch.cuda.synchronize()
        reset_launches()
        out, printed = run_cli([cfg_path, '--json-out', prefix])
        got = read_launches()
        n_batches = out['timings']['batches']
        want = {k: v * n_batches for k, v in per_fwd.items()}
        print(f'eval: CLI launches {got} over {n_batches} batches of '
              f'{data.batch_size}', flush=True)
        if n_batches != n_batches_data or got != want:
            fail(f'CLI launches {got} != {want} for {n_batches_data} '
                 f'batches')
        ids = sorted(r['id'] for r in images)
        if sorted(out['results']) != ids:
            fail('the CLI results do not hold every image once')
        for k in ('bbox', 'keypoints'):
            if not os.path.isfile(out['files'][k]):
                fail(f'{out["files"][k]} was not written')
        copypaste(printed, 'bbox', 12)
        copypaste(printed, 'keypoints', 10)
        n_dets = sum(len(r[0]) for r in out['results'].values())
        if n_dets == 0:
            fail('the CLI scored no detection')

        # the loop adds nothing: run_inference's detections of a batch are
        # the predict function's, cut by valid
        canvas, first = next(iter(firsts.items()))
        dets = make_predict_fn(model, cfg, canvas)(first)
        timings = {}
        loop = run_inference(model, cfg, DataLoader(
            dataset, data.batch_size, train=False), verbose=False,
            timings=timings)
        for i, img_id in enumerate(first['img_id'].tolist()):
            v = dets['valid'][i].cpu().numpy()
            direct = [dets[k][i].cpu().numpy()[v]
                      for k in ('det_bboxes', 'det_labels', 'det_kpts')]
            for a, b in zip(loop[img_id], direct):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    fail(f'run_inference differs from the predict call on '
                         f'image {img_id}')
        print(f'eval: run_inference bit-equal to make_predict_fn on the '
              f'{len(first["img_id"])} images of the first batch', flush=True)
        phase_profile(torch, model, cfg, first, gpu)
        del model
        torch.cuda.empty_cache()

        # multi-scale / flip TTA on a subset
        with open(os.path.join(root, 'validation-coco_style.json')) as f:
            coco = json.load(f)
        keep = {im['id'] for im in coco['images'][:TTA_IMAGES]}
        coco['images'] = [im for im in coco['images'] if im['id'] in keep]
        coco['annotations'] = [a for a in coco['annotations']
                               if a['image_id'] in keep]
        with open(os.path.join(root, 'subset.json'), 'w') as f:
            json.dump(coco, f)
        tta_cfg = eval_config(root, 'tta_cfg.py')
        with open(tta_cfg, 'a') as f:
            f.write("config = config.replace(val_data=dataclasses.replace("
                    "config.val_data, ann_file=_DATA_ROOT + "
                    "'/subset.json'))\n")
        t0 = time.perf_counter()
        reset_launches()
        tta, printed = run_cli([tta_cfg, '--aug', '--aug-scales',
                                *TTA_SCALES, '--batch-size', '2',
                                '--json-out', os.path.join(root, 'tta')])
        tta_s = time.perf_counter() - t0
        copypaste(printed, 'bbox', 12)
        if sorted(tta['results']) != sorted(keep):
            fail('TTA results do not hold every image of the subset once')
        subset = DeepFashion2Dataset(load_config(tta_cfg).val_data,
                                     train=False)
        # each (long, short) pair of TTA_SCALES plain and flipped
        variants = len(TTA_SCALES) // 2 * 2
        tta_batches = variants * len(DataLoader(subset, 2, train=False))
        want = {k: v * tta_batches for k, v in per_fwd.items()}
        if read_launches() != want:
            fail(f'TTA launches {read_launches()} != {want} for '
                 f'{tta_batches} batches')
        print(f'eval: TTA over {TTA_IMAGES} images, batch 2, at scales '
              f'{" ".join(TTA_SCALES)} with flips: {tta_s:.1f} s, '
              f'{tta_batches} batches, launches {read_launches()}',
              flush=True)

        t = out['timings']
        n = t['images']
        cli_ms = 1e3 * t['predict_s'] / n_batches
        print(f'eval: {len(images)} images in {n_batches} batches '
              f'({n} with the wrap-padding); host data '
              f'{data_ms:.1f} ms a batch (read, resize, pad, collate; one '
              f'thread, {image_io.BACKEND}; an image {img_ms:.1f} ms, '
              f'{own_ms:.1f} with NumPy); predict '
              f'{1e3 * timings["predict_s"] / timings["batches"]:.1f} ms a '
              f'batch (warm; the CLI run {cli_ms:.1f} with the first '
              f'calls), waiting for data '
              f'{1e3 * t["data_s"] / n_batches:.1f} ms a batch; CLI wall '
              f'{t["wall_s"]:.2f} s (setup '
              f'{t["setup_s"]:.2f}, inference {t["infer_s"]:.2f}, '
              f'evaluation {t["eval_s"]:.2f}): inference '
              f'{len(images) / t["infer_s"]:.2f} img/s, evaluation '
              f'{len(images) / t["eval_s"]:.2f} img/s, wall '
              f'{len(images) / t["wall_s"]:.2f} img/s ({gpu})', flush=True)
        return got
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main():
    # prove that nothing of JAX or of the JAX package is needed: any import
    # of them now fails
    for mod in ('jax', 'flax', 'kgdet_tpu'):
        sys.modules[mod] = None
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kgdet_tpu_torch.ops import _build

    gpu = gpu_line()
    print(gpu, flush=True)          # name, power limit as nvidia-smi gives
    print(f'torch {torch.__version__}, cuda {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f'build: {len(logs)} sources compiled by nvcc in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    build_report(_build, logs)

    gen = torch.Generator().manual_seed(SEED)
    kernels = phase_kernels(torch, gen)
    launches = {}                   # main path -> {kernel: launches}
    prefix = dict(stem_pool=1, frozen_bottleneck=3)

    # the KGDet cascade, served and trained
    model, cfg, req, launches['serving'] = phase_serving(
        torch, gpu, CONFIG, launch_counts(deform_fused=12, **prefix))
    phase_profile(torch, model, cfg, req, gpu)
    model.use_plain_kernels(True)
    phase_profile(torch, model, cfg, req, gpu)
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batch, launches['training'] = \
        phase_training(torch, gpu)
    phase_train_profile(torch, model, cfg, optimizer, batch, gpu)
    del model, optimizer
    torch.cuda.empty_cache()

    # the serial / parallel RepPoints family over the 5-level FPN
    serial_fwd = launch_counts(deform_fused=2 * len(SERIAL_LEVELS), **prefix)
    model, cfg, req, launches['serial_serving'] = phase_serving(
        torch, gpu, SERIAL_CONFIG, serial_fwd)
    phase_profile(torch, model, cfg, req, gpu)
    launches['per_block_backbone'] = phase_per_block_backbone(
        torch, model, req, gpu)
    del model
    torch.cuda.empty_cache()
    model, _, _, launches['parallel_serving'] = phase_serving(
        torch, gpu, PARALLEL_CONFIG, serial_fwd, n_reqs=1, compare=False)
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batch, launches['serial_training'] = \
        phase_serial_training(torch, gpu)
    phase_train_profile(torch, model, cfg, optimizer, batch, gpu)
    del model, optimizer
    torch.cuda.empty_cache()

    # the evaluation path: dataset, loader, the CLI, TTA
    launches['eval'] = phase_eval(
        torch, gpu, launch_counts(deform_fused=12, **prefix))

    src = 'kgdet_tpu_torch/csrc/'
    ref = 'kgdet_tpu/ops/'
    meta = {
        'deform_fused': (src + 'deform_fused.cu',
                         ref + 'pallas_deform.py:595'),
        'deform_sample_split': (src + 'deform_split.cu',
                                ref + 'pallas_deform.py:302'),
        'deform_sample_bwd': (src + 'deform_bwd.cu',
                              ref + 'pallas_deform.py:1126'),
        'stem_pool': (src + 'prefix_mma.cuh', ref + 'pallas_stem.py:122'),
        'frozen_bottleneck': (src + 'prefix_mma.cuh',
                              ref + 'pallas_stem.py:215'),
        'deform_sample_cols': (src + 'deform_sample.cu',
                               ref + 'pallas_deform.py:177'),
        'fused_bottleneck': (src + 'prefix_mma.cuh',
                             ref + 'pallas_resblock.py:103'),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        if sum(by_path.values()) == 0:
            fail(f'{name} was launched on no main path')
        rows.append({'name': name, 'route': 'cuda', 'source': source,
                     'replaces': replaces,
                     'launches': sum(by_path.values()),
                     **{f'launches_{path}': n for path, n in by_path.items()},
                     **kernels[name]})
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
