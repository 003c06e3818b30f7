#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kgdet_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Setup: builds the hand-written kernels from kgdet_tpu_torch/csrc/ with nvcc
(sm_90a) and times the build.
Phase 1: each kernel (K1 deform_fused, K4 stem_pool, K5 frozen_bottleneck)
against its plain PyTorch version at the serving shapes (batch 2), in f32
(rtol 1e-5, atol 1e-4) and in bf16 (the kernel's max error against an f32
plain run is at most 2x the bf16 plain run's), with median times by CUDA
events.
Phase 2: serves 4 requests of 2 uint8 images at full width
(configs/kgdet_moment_r50_fpn_1x_deepfashion2.py, bf16, 800x1344, seeded
random weights) through make_predict_fn, checks the launch counts and the
outputs, and compares the stage-3 head outputs with the same model on its
plain kernels, in bf16 and in f32.
Phase 3: where the time goes: torch.profiler over served batches run stage
by stage (normalize, backbone, neck, head, decode), giving device time per
stage and per kernel and the device's idle share of the window.

Prints the card's name and power limit, one line per check, a JSON line of
the kernels, and as its last line {"ok": true, "device": {...}}. Exits
nonzero, with no result line, when a check fails or no CUDA device is
present. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs',
                      'kgdet_moment_r50_fpn_1x_deepfashion2.py')
B = 2
CANVAS = (800, 1344)
SEED = 0
F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_RATIO = 2.0
# tight f32 bound on the whole-model comparison, relative to each output's
# scale: both sides are f32 end to end and differ only in summation order
MODEL_F32_REL = 1e-3


def fail(msg):
    raise SystemExit(f'chip_smoke: FAIL: {msg}')


def gpu_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ''


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


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_pair(name, kernel, plain, args_f32, cast_bf16):
    """Kernel vs plain on the same inputs: f32 within F32_TOL; bf16 kernel
    error vs the f32 plain run at most BF16_RATIO x the bf16 plain run's.
    Returns (f32 max err, bf16 kernel ms, bf16 plain ms)."""
    import torch
    got = kernel(*args_f32)
    want = plain(*args_f32)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f'{name}: shape {tuple(got.shape)} != {tuple(want.shape)}')
    if not torch.allclose(got.float(), want.float(), **F32_TOL):
        fail(f'{name} f32: max abs err {max_err(got, want):.3e} over '
             f'rtol {F32_TOL["rtol"]} atol {F32_TOL["atol"]}')
    e32 = max_err(got, want)

    args16 = cast_bf16(args_f32)
    ref = plain(*[a.float() if torch.is_tensor(a) and a.is_floating_point()
                  else a for a in args16])
    k16 = kernel(*args16)
    p16 = plain(*args16)
    torch.cuda.synchronize()
    ek, ep = max_err(k16, ref), max_err(p16, ref)
    if not torch.isfinite(k16.float()).all() or ek > BF16_RATIO * ep:
        fail(f'{name} bf16: kernel err {ek:.3e} > {BF16_RATIO} x plain err '
             f'{ep:.3e}')
    ms = median_ms(lambda: kernel(*args16))
    pms = median_ms(lambda: plain(*args16))
    print(f'{name}: f32 max_abs_err {e32:.3e} | bf16 max_abs_err vs f32 '
          f'plain: kernel {ek:.3e}, plain {ep:.3e} | bf16 median ms: '
          f'kernel {ms:.4f}, plain {pms:.4f}', flush=True)
    return e32, ms, pms


def phase_kernels(torch, gen):
    from kgdet_tpu_torch.ops import deform_kernels as dk
    from kgdet_tpu_torch.ops import stem_kernels as sk

    dev = 'cuda'

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev)

    results = {}
    # K1 at the three column widths: map 25x42x256, P = 1050, F = 256
    H, W, C = 25, 42, 256
    P = H * W
    stats = []
    for t in (9, 25, 49):
        feat = randn(B, H, W, C)
        pos = torch.rand((B, P, t, 2), generator=gen).to(dev)
        pos = pos * torch.tensor([H + 4.0, W + 4.0], device=dev) - 2.0
        w = randn(t, C, C, std=(t * C) ** -0.5)

        def cast(args):
            f, p, wt = args
            return [f.to(torch.bfloat16), p, wt.to(torch.bfloat16)]
        stats.append(check_pair(f'K1 deform_fused t={t}',
                                dk.deform_conv_fused, dk.deform_conv_fused_ref,
                                [feat, pos, w], cast))
    # 4 calls per column and forward: 2 deformable stages x 2 branches
    results['deform_fused'] = (max(s[0] for s in stats),
                               sum(4 * s[1] for s in stats),
                               sum(4 * s[2] for s in stats))

    # K4 on both canvas orientations (timed on the first)
    sw = randn(7, 7, 3, 64, std=(2.0 / 147) ** 0.5)
    sb = randn(64, std=0.1)
    k4 = []
    for hw in (CANVAS, CANVAS[::-1]):
        x = randn(B, *hw, 3)
        k4.append(check_pair(
            f'K4 stem_pool {hw[0]}x{hw[1]}', sk.stem_pool, sk.stem_pool_ref,
            [x, sw, sb], lambda a: [a[0].to(torch.bfloat16), a[1], a[2]]))
    results['stem_pool'] = k4[0]

    # K5 for the three layer1 blocks at the stem output shape
    H4, W4 = CANVAS[0] // 4, CANVAS[1] // 4
    k5 = []
    for i, cin in enumerate((64, 256, 256)):
        x = torch.relu(randn(B, H4, W4, cin))
        blk = [randn(cin, 64, std=cin ** -0.5), randn(64, std=0.1),
               randn(3, 3, 64, 64, std=(9 * 64) ** -0.5), randn(64, std=0.1),
               randn(64, 256, std=64 ** -0.5), randn(256, std=0.1)]
        blk += ([randn(cin, 256, std=cin ** -0.5), randn(256, std=0.1)]
                if i == 0 else [None, None])
        k5.append(check_pair(
            f'K5 frozen_bottleneck block {i} (Cin {cin})',
            sk.frozen_bottleneck, sk.frozen_bottleneck_ref, [x] + blk,
            lambda a: [a[0].to(torch.bfloat16)] + a[1:]))
    results['frozen_bottleneck'] = (max(s[0] for s in k5),
                                    sum(s[1] for s in k5),
                                    sum(s[2] for s in k5))
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
    """The kernel wrappers of the serving path, by kernel name."""
    from kgdet_tpu_torch.ops.deform_kernels import deform_conv_fused
    from kgdet_tpu_torch.ops.stem_kernels import frozen_bottleneck, stem_pool
    return {'deform_fused': deform_conv_fused, 'stem_pool': stem_pool,
            'frozen_bottleneck': frozen_bottleneck}


def serve(torch, predict, reqs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = [predict(r) for r in reqs]
    torch.cuda.synchronize()
    return dets, time.perf_counter() - t0


def stage3(outs):
    return {k: outs[0][k][-1] for k in ('cls', 'kpt', 'bbox')}


def phase_serving(torch, gpu):
    from kgdet_tpu_torch.api import build_model, load_config, make_predict_fn
    from kgdet_tpu_torch.ops.image import device_normalize

    cfg = load_config(CONFIG)
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, score_thr=0.0))
    print(f'serving: {os.path.relpath(CONFIG, ROOT)}, {cfg.compute_dtype}, '
          f'canvas {CANVAS[0]}x{CANVAS[1]}, batch {B}, random weights '
          f'(seed {SEED}); test.score_thr set to 0.0 so NMS has work under '
          'random weights', flush=True)
    model = build_model(cfg).init_weights(SEED).cuda().eval()
    predict = make_predict_fn(model, cfg, CANVAS)
    reqs = make_requests(4, SEED)
    per_fwd = {'deform_fused': 12, 'stem_pool': 1, 'frozen_bottleneck': 3}

    predict(reqs[0])                      # warm-up: cuDNN plans, allocator
    for fn in wrappers().values():
        fn.launches = 0
    dets, secs = serve(torch, predict, reqs)
    got = {name: fn.launches for name, fn in wrappers().items()}
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

    model.use_plain_kernels(True)
    predict(reqs[0])
    _, psecs = serve(torch, predict, reqs)
    model.use_plain_kernels(False)
    pips = B * len(reqs) / psecs
    print(f'serving: {len(reqs)} requests x {B} images, {n_valid} valid '
          f'detections, launches {launches}; {ips:.2f} img/s with kernels, '
          f'{pips:.2f} img/s with plain versions ({gpu})', flush=True)

    # stage-3 head outputs: kernels vs plain, bf16 and f32
    image = device_normalize(torch.as_tensor(reqs[0]['image']).cuda(),
                             torch.as_tensor(reqs[0]['img_hw']).cuda())
    with torch.inference_mode():
        runs = {}
        for dtype in (torch.bfloat16, torch.float32):
            model.dtype = dtype
            for plain in (False, True):
                model.use_plain_kernels(plain)
                runs[dtype, plain] = stage3(model(image))
        model.dtype = torch.bfloat16
        model.use_plain_kernels(False)
    ref = runs[torch.float32, True]
    for k in ('cls', 'kpt', 'bbox'):
        scale = max(1.0, ref[k].float().abs().max().item())
        e32 = max_err(runs[torch.float32, False][k], ref[k])
        ek = max_err(runs[torch.bfloat16, False][k], ref[k])
        ep = max_err(runs[torch.bfloat16, True][k], ref[k])
        print(f'stage-3 {k}: f32 kernels vs plain {e32:.3e} (bound '
              f'{MODEL_F32_REL * scale:.3e}); bf16 vs f32 plain: kernels '
              f'{ek:.3e}, plain {ep:.3e} (bound {BF16_RATIO} x plain)',
              flush=True)
        if not e32 <= MODEL_F32_REL * scale:
            fail(f'stage-3 {k}: f32 kernel model differs by {e32:.3e}')
        if not ek <= BF16_RATIO * ep:
            fail(f'stage-3 {k}: bf16 kernel model err {ek:.3e} > '
                 f'{BF16_RATIO} x plain {ep:.3e}')
    return model, cfg, reqs[0], launches


STAGES = ('normalize', 'backbone', 'neck', 'head', 'decode')


def phase_profile(torch, model, cfg, req, steps=4):
    """Where the time goes over `steps` served batches, stages labelled
    here around the calls into each layer: per stage its device span
    (first to last kernel, gaps included) and its busy time (the kernels
    in that span); per kernel its device time; the device's idle share of
    the wall time of the window."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from kgdet_tpu_torch.models.families import get_head_family
    from kgdet_tpu_torch.ops.image import device_normalize

    decode = get_head_family(cfg.head.type).make_decode(cfg, CANVAS)
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
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in gpu
             if e.name in STAGES]
    span_ms, busy_ms, kern = defaultdict(float), defaultdict(float), {}
    for s0, s1, name in spans:
        span_ms[name] += (s1 - s0) / 1e3 / steps
    for e in gpu:
        if e.name in STAGES:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        mid = (e.time_range.start + e.time_range.end) / 2
        stage = next((n for s0, s1, n in spans if s0 <= mid <= s1), 'other')
        busy_ms[stage] += ms
        t, n = kern.get(e.name, (0.0, 0))
        kern[e.name] = (t + ms, n + 1)
    busy = sum(busy_ms.values())
    kind = 'plain versions' if model.backbone.plain_prefix else 'kernels'
    print(f'profile ({kind}): {steps} batches of {B} under torch.profiler: '
          f'{wall:.3f} ms per batch, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.3f}', flush=True)
    print('  stage device span / busy ms per batch: ' + ', '.join(
        f'{s} {span_ms[s]:.3f}/{busy_ms[s]:.3f}' for s in STAGES), flush=True)
    for name, (ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f'  {ms:8.3f} ms x{n // steps:<4d} {name[:96]}')


def main():
    # prove that nothing of JAX is needed: any import of it now fails
    for mod in ('jax', 'flax'):
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
    for name, log in logs.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}')

    gen = torch.Generator().manual_seed(SEED)
    kernels = phase_kernels(torch, gen)
    model, cfg, req, launches = phase_serving(torch, gpu)
    phase_profile(torch, model, cfg, req)
    model.use_plain_kernels(True)
    phase_profile(torch, model, cfg, req)
    model.use_plain_kernels(False)

    src = 'kgdet_tpu_torch/csrc/'
    meta = {
        'deform_fused': (src + 'deform_fused.cu',
                         'kgdet_tpu/ops/pallas_deform.py:595'),
        'stem_pool': (src + 'stem_layer1.cu',
                      'kgdet_tpu/ops/pallas_stem.py:122'),
        'frozen_bottleneck': (src + 'stem_layer1.cu',
                              'kgdet_tpu/ops/pallas_stem.py:215'),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        err, ms, pms = kernels[name]
        rows.append({'name': name, 'route': 'cuda', 'source': source,
                     'replaces': replaces, 'launches': launches[name],
                     'max_abs_err': err, 'ms': ms, 'plain_ms': pms})
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
