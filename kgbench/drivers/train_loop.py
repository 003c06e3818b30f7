"""Training: the program's own loop on a synthetic DeepFashion2-format set
written under the run's temporary directory: ``runner.Runner.setup`` with
the benchmark's weights and dataset, the Runner's loader (4 threads), its
``_device_prefetch`` and the train step of each canvas, stepped as
``Runner.train_epoch`` steps them (its logger included).

Set-up drives the one Runner from the seed through its first steps, which
the reference follows (``checked_steps``), then until every canvas has
stepped ``warmup_steps_per_canvas`` times; the same Runner then runs the
window: whole steps until ``seconds`` have passed, a synchronize at the
end. ``train_img_s`` is the images of those steps over the window's
seconds. The wait at each ``next()`` of the prefetch iterator is timed.
With tracing, ``traced_steps`` more steps run under the profiler with
synchronized spans around the forward's layers, the loss, the backward
and the optimizer. Then the program is freed and the reference derives
the first steps' batches from the same files and records, and takes the
same steps in float32 from the same weights.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from kgbench import check, program, serving, timeline, traffic, weights


def run(cell, seed, seconds, trace, t0, device):
    root = tempfile.mkdtemp(prefix='kgbench-train-')
    try:
        return _run(cell, seed, seconds, trace, t0, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def program_config(cell, ann_file, folder):
    cfg = program.load_config(cell.root, cell.config)
    return dataclasses.replace(cfg, train_data=dataclasses.replace(
        cfg.train_data, ann_file=ann_file, img_prefix=folder))


def _run(cell, seed, seconds, trace, t0, device, root):
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.runner import Runner
    spec, mix = cell.config, cell.traffic
    ann_file, folder, records, names = traffic.train_set(mix, seed, root)
    cfg = program_config(cell, ann_file, folder)
    ref = cell.module('reference', spec['reference'])
    w = weights.make(ref.param_specs(spec['model']), seed, device)
    runner = Runner(cfg, work_dir=os.path.join(root, 'work'), device=device)
    runner.setup(init_state_dict=w,
                 train_dataset=DeepFashion2Dataset(cfg.train_data,
                                                   train=True))
    opt = runner.optimizer
    feed = runner._device_prefetch(itertools.islice(
        runner.train_loader, runner.steps_per_epoch))
    B = cfg.train_data.batch_size

    def step(it):
        """One step as Runner.train_epoch takes it, its logger's interval
        synchronize included; (batch, logs, wait at the feed)."""
        t = time.perf_counter()
        batch = next(feed)
        wait = time.perf_counter() - t
        logs = runner._get_step_fn(tuple(batch['image'].shape[1:3]))(batch)
        runner.step += 1
        lr = 0.0
        if (it + 1) % runner.logger.interval == 0:
            runner._sync()
            lr = float(runner.schedule(runner.step - 1))
        runner.logger.log_iter(runner.epoch, it, runner.steps_per_epoch,
                               logs, lr, 0.0)
        return batch, logs, wait

    checked, losses, seen = [], [], {}
    it = 0
    while len(checked) < mix['checked_steps'] or min(
            seen.get(tuple(c), 0) for c in spec['data']['canvases']) < \
            mix['warmup_steps_per_canvas']:
        batch, logs, _ = step(it)
        canvas = tuple(batch['image'].shape[1:3])
        seen[canvas] = seen.get(canvas, 0) + 1
        if len(checked) < mix['checked_steps']:
            checked.append({k: v.detach().cpu().clone()
                            for k, v in batch.items()})
            losses.append(logs['loss'])
            if len(checked) == 1:
                first = {n: m.detach().clone()
                         for n, m in zip(opt.names, opt.momentum)}
            if len(checked) == mix['checked_steps']:
                after = {n: p.detach().clone()
                         for n, p in zip(opt.names, opt.params)}
        it += 1
    serving.reset_peak(device)
    setup_s = time.perf_counter() - t0

    waits, n = [], 0
    start = time.perf_counter()
    while True:
        _, _, wait = step(it)
        waits.append(wait)
        it, n = it + 1, n + 1
        if time.perf_counter() - start >= seconds:
            break
    serving.sync(device)
    elapsed = time.perf_counter() - start
    peak = serving.peak_bytes(device)
    if it >= runner.steps_per_epoch:
        raise RuntimeError(f'{it} steps pass the epoch of '
                           f'{runner.steps_per_epoch}: add records')
    obs = {'images': n * B, 'seconds': elapsed, 'batch': B,
           'model': spec['model'], 'canvases': spec['data']['canvases'],
           'data_wait_s': waits}
    if trace:
        k = [it]

        def one():
            step(k[0])
            k[0] += 1
        obs['timeline'], obs['stage_ms'] = traced_steps(
            runner.model, opt, one, mix['traced_steps'])
        obs['flops_per_image'] = train_flops_per_image(
            ref, w, spec, spec['data']['canvases'][0], device)
    losses = [float(v) for v in losses]
    del runner, opt, feed
    serving.free()

    readings = reference_readings(cell, w, records, names, folder, checked,
                                  losses, first, after, device)
    correct, rows = check.judge(readings, spec['train_limits'])
    for name in sorted(set(readings) - set(spec['train_limits'])):
        print(f'reading {name} {readings[name]!r} (not compared)',
              file=sys.stderr)
    return {'correct': correct, 'attempted': n * B, 'failed': 0,
            'e2e': {'train_img_s': n * B / elapsed,
                    'peak_mem_gib': peak / 2 ** 30, 'setup_s': setup_s},
            'obs': obs, 'checks': rows, 'peak_bytes': peak}


def traced_steps(model, opt, call, calls):
    """Runs ``call()`` ``calls`` times under the profiler with ranges of the
    forward's layers, the loss (the head's end to the backward), the
    backward (``Tensor.backward``) and the optimizer's step, then ``calls``
    times with those spans synchronized and timed: (timeline, stage ms
    lists)."""
    backward, step = torch.Tensor.backward, opt.step
    out = []
    for timed in (False, True):
        spans = timeline.StageSpans(serving.stage_modules(model), 'loss',
                                    timed)

        def wrap(name, fn, before=None, spans=spans):
            def wrapper(*args, **kwargs):
                if before is not None:
                    before()
                spans.sync()
                t = time.perf_counter()
                with torch.profiler.record_function(f'kgbench.{name}'):
                    result = fn(*args, **kwargs)
                    spans.sync()
                spans.ms[name].append((time.perf_counter() - t) * 1e3)
                return result
            return wrapper

        torch.Tensor.backward = wrap('backward', backward, spans.end_call)
        opt.step = wrap('optimizer', step)
        try:
            with spans:
                if timed:
                    for _ in range(calls):
                        call()
                else:
                    out.append(timeline.profiled(call, calls))
        finally:
            torch.Tensor.backward = backward
            del opt.step
    return out[0], dict(spans.ms)


def train_flops_per_image(ref, w, spec, canvas, device):
    """Operations of the reference's forward and backward for one image
    (the free parameters' gradients), as FlopCounterMode counts them."""
    from kgbench import roofline
    serving.exact_float32()
    free = free_params(spec, w)
    params = {k: (v.detach().requires_grad_(True) if k in free else v)
              for k, v in w.items()}
    x = torch.zeros((1, 3) + tuple(canvas), device=device)

    def step():
        outs = ref.forward(params, x, spec['model'])
        sum(t.sum() for lvl in outs for t in lvl.values()).backward()
    return roofline.model_flops(step)


def free_params(spec, w):
    """The parameters the optimizer updates: every floating one outside the
    stem and the frozen stages."""
    frozen = ('backbone.conv1.', 'backbone.bn1.') + tuple(
        f'backbone.layer{s}.' for s in range(
            1, spec['model']['frozen_stages'] + 1))
    return [k for k, v in w.items() if v.is_floating_point()
            and not k.startswith(frozen)
            and not k.endswith(('running_mean', 'running_var'))]


def reference_steps(ref, loss_mod, spec, w, batches, device, quant=None,
                    keep=None):
    """The reference's first steps from weights ``w`` on its own batches:
    (losses, momentum after the first step, parameters after the last,
    first-step gradients). ``keep`` (a slice) takes only those images of
    each batch into the loss (a fault)."""
    from kgbench.reference import train_batch
    m = spec['model']
    free = free_params(spec, w)
    params = {k: w[k].detach().clone() for k in free}
    momentum, losses, first, grads1 = {}, [], None, None
    for k, b in enumerate(batches):
        if keep is not None:
            b = {n: v[keep] for n, v in b.items()}
        x = serving.normalized(b['image'], b['valid_hw'], m['img_mean'],
                               m['img_std']).to(device)
        feed = {n: torch.as_tensor(v).to(device) for n, v in b.items()}
        live = {n: p.requires_grad_(True) for n, p in params.items()}
        full = dict(w, **live)
        outs = ref.forward(full, x, m, quant=quant)
        total, _ = loss_mod.loss(outs, feed, m, tuple(b['image'].shape[1:3]))
        grads = torch.autograd.grad(total, [live[n] for n in free],
                                    allow_unused=True)
        grads = {n: (torch.zeros_like(params[n]) if g is None else g)
                 for n, g in zip(free, grads)}
        for p in params.values():
            p.requires_grad_(False)
        train_batch.sgd_step(params, grads, momentum, k, spec['optim'])
        losses.append(float(total.detach()))
        if k == 0:
            first = {n: v.clone() for n, v in momentum.items()}
            grads1 = grads
        del outs, total, grads
    return losses, first, params, grads1


def reference_batches(cell, records, names, folder, dtype=torch.float32):
    """The first steps' batches, derived again from the files and records
    (the recipe's sampling and flips, kgbench/reference/train_batch.py)."""
    import cv2

    from kgbench.reference import train_batch
    spec, mix = cell.config, cell.traffic
    d, o = spec['data'], spec['train']
    wide = np.array([r['width'] / r['height'] > 1 for r in records])
    picks = train_batch.epoch_batches(wide, o['batch_size'], 0,
                                      o['seed'])[:mix['checked_steps']]
    pixels = {r['file']: None for i in np.concatenate(picks)
              for r in [records[i]]}
    for f in pixels:
        pixels[f] = cv2.imread(os.path.join(folder, names[f]),
                               cv2.IMREAD_COLOR)
    return [train_batch.batch(
        records, pixels, idx,
        train_batch.flips(idx, 0, o['seed'], o['flip_ratio']),
        d['canvases'], d['img_scale'], o['max_gts'], dtype) for idx in picks]


def leaf_gap(program, reference, include):
    """The worst leaf's gap between the two sides' norms, over the larger of
    its reference norm and the median leaf's."""
    norms = {n: float(torch.linalg.vector_norm(reference[n].float()))
             for n in include}
    median = statistics.median(norms.values())
    return float(np.max([abs(float(torch.linalg.vector_norm(
        program[n].float())) - norms[n]) / max(norms[n], median)
        for n in include]))


def included_leaves(grads):
    """Leaves whose reference gradient is not nought to rounding: at least
    a thousandth of the median leaf's norm."""
    norms = {n: float(torch.linalg.vector_norm(g)) for n, g in grads.items()}
    median = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * median]


def batch_gap(program_batches, reference_batches):
    """The largest of: any coordinate of a garment's box or visible
    keypoint apart (pixels), the mean pixel level apart inside the images,
    and 1000 where labels, masks or extents differ."""
    worst = 0.0
    for p, r in zip(program_batches, reference_batches, strict=True):
        p = {k: np.asarray(v) for k, v in p.items()}
        for k in ('gt_labels', 'gt_mask', 'valid_hw'):
            if not np.array_equal(p[k].astype(np.int64),
                                  r[k].astype(np.int64)):
                return 1000.0
        if p['image'].shape != r['image'].shape:
            return 1000.0
        vis = r['gt_kpts'][..., 2] > 0
        gap = max(float(np.abs(p['gt_bboxes'] - r['gt_bboxes']).max()),
                  float(np.abs(p['gt_kpts'][..., :2]
                               - r['gt_kpts'][..., :2])[vis].max(
                      initial=0.0)),
                  float(np.abs(p['gt_kpts'][..., 2]
                               - r['gt_kpts'][..., 2]).max()))
        for b, (h, w) in enumerate(r['valid_hw']):
            diff = np.abs(p['image'][b, :h, :w].astype(np.int16)
                          - r['image'][b, :h, :w].astype(np.int16))
            gap = max(gap, float(diff.mean()))
        worst = max(worst, gap)
    return worst


def side_gaps(side, reference, w, device):
    """loss_gap, grad_gap and update_gap of one side's first steps
    (losses, momentum after the first step, parameters after the last)
    against the reference's."""
    losses, first, after = side[:3]
    r_losses, r_first, r_after, grads1 = reference
    include = included_leaves(grads1)
    return {
        'loss_gap': float(np.max([abs(a - b) / abs(b) for a, b in zip(
            losses, r_losses, strict=True)])),
        'grad_gap': leaf_gap({n: first[n].to(device) for n in include},
                             r_first, include),
        'update_gap': leaf_gap(
            {n: after[n].to(device) - w[n] for n in include},
            {n: r_after[n] - w[n] for n in include}, include),
    }


def reference_readings(cell, w, records, names, folder, checked, losses,
                       first, after, device):
    """The numbers that decide ``correct``, from the first steps."""
    from kgbench.reference import point_loss
    spec = cell.config
    ref = cell.module('reference', spec['reference'])
    serving.exact_float32()
    batches = reference_batches(cell, records, names, folder)
    readings = side_gaps((losses, first, after), reference_steps(
        ref, point_loss, spec, w, batches, device), w, device)
    readings['batch_gap'] = batch_gap(checked, batches)
    return readings


def control_readings(cell, seed, device):
    """Against the float32 reference's first steps on the same set: the
    control (the reference's steps with every product in float8, and its
    batch derived in bfloat16) and the fault of half of each batch left out,
    the loss's mean over the rest. A step that returns its state unchanged
    reads 1 on update_gap by that number's definition."""
    from kgbench.reference import point_loss
    spec, mix = cell.config, cell.traffic
    ref = cell.module('reference', spec['reference'])
    serving.exact_float32()
    root = tempfile.mkdtemp(prefix='kgbench-train-')
    try:
        _, folder, records, names = traffic.train_set(mix, seed, root)
        w = weights.make(ref.param_specs(spec['model']), seed, device)
        batches = reference_batches(cell, records, names, folder)
        low = reference_batches(cell, records, names, folder,
                                torch.bfloat16)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    exact = reference_steps(ref, point_loss, spec, w, batches, device)
    control = side_gaps(reference_steps(ref, point_loss, spec, w, batches,
                                        device, quant=ref.fp8),
                        exact, w, device)
    control['batch_gap'] = batch_gap(low, batches)
    half = side_gaps(reference_steps(
        ref, point_loss, spec, w, batches, device,
        keep=slice(0, spec['train']['batch_size'] // 2)), exact, w, device)
    return {'control': control, 'half_batch': half}
