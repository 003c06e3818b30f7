"""Offline serving: one caller in a closed loop sends whole batches, as the
evaluation loader yields them, through the program's
``api.make_predict_fn`` and takes each batch's detections to the host.

The window runs whole batches until ``seconds`` have passed and stops at
the end of the last one; ``serve_img_s`` is the images completed over the
window's seconds. With tracing, a stretch of ``traced_batches`` more
batches runs with stage spans under the profiler. Then the program is
freed, and the sampled batches' head outputs and detections are held
against the plain reference.
"""
from __future__ import annotations

import time

from kgbench import check, serving, traffic


def run(cell, seed, seconds, trace, t0, device):
    from kgdet_tpu_torch.api import make_predict_fn
    spec, mix = cell.config, cell.traffic
    cfg, w, ref, model = serving.setup(cell, seed, device)
    batches, order = traffic.offline_batches(mix, spec['data'], seed)
    host = [serving.host_batch(b, device) for b in batches]
    canvases = {tuple(b['image'].shape[1:3]) for b in batches}
    predict = {c: make_predict_fn(model, cfg, c) for c in canvases}

    def serve(i):
        b = host[order[i % len(order)]]
        dets = predict[tuple(b['image'].shape[1:3])](b)
        return {k: v.cpu() for k, v in dets.items()}

    for i in range(len(order) * mix['warmup_rounds']):
        serve(i)
    cap = serving.Capture(model)
    # the sampled batches: one of each pool batch among the first round
    sampled = set(traffic.sample(seed, range(len(order)),
                                 mix['sampled_batches']))
    kept = []
    serving.reset_peak(device)
    setup_s = time.perf_counter() - t0

    n, start = 0, time.perf_counter()
    while True:
        dets = serve(n)
        if n in sampled:
            kept.append((order[n % len(order)],
                         serving.head_to_cpu(cap.last), dets))
        n += 1
        elapsed = time.perf_counter() - start
        if elapsed >= seconds:
            break
    peak = serving.peak_bytes(device)
    obs = {'images': n * mix['batch'], 'seconds': elapsed,
           'batch': mix['batch'], 'model': spec['model'],
           'canvases': sorted(canvases)}
    if trace:
        k = [n]

        def one():
            serve(k[0])
            k[0] += 1
        obs['timeline'], obs['stage_ms'] = serving.traced_stretch(
            model, one, mix['traced_batches'])
        obs['flops_per_image'] = serving.flops_per_image(
            ref, w, spec, sorted(canvases)[0], device)
    cap.close()
    del model, predict, host, cap
    serving.free()

    items = []
    for idx, outs, dets in kept:
        b = batches[idx]
        items.append((serving.normalized(b['image'], b['img_hw'],
                                         spec['model']['img_mean'],
                                         spec['model']['img_std']),
                      outs,
                      check.valid_rows(*(dets[k].numpy() for k in (
                          'det_bboxes', 'det_labels', 'det_kpts', 'valid'))),
                      b['img_hw'], b['scale_factor']))
    readings = serving.reference_gaps(
        ref, cell.module('reference', spec['decode']), spec,
        {'weights': w, 'items': items}, device)
    correct, rows = check.judge(readings, spec['limits'])
    correct = correct and len(kept) == len(sampled)
    return {'correct': correct, 'attempted': n * mix['batch'], 'failed': 0,
            'e2e': {'serve_img_s': n * mix['batch'] / elapsed,
                    'peak_mem_gib': peak / 2 ** 30, 'setup_s': setup_s},
            'obs': obs, 'checks': rows, 'peak_bytes': peak}


def control_readings(cell, seed, device):
    return serving.control_readings(cell, control_inputs(cell, seed), seed,
                                    device)


def control_inputs(cell, seed):
    """The reference inputs of a run's sampled batches, for the control:
    (image, img_hw, scale_factor) each."""
    spec, mix = cell.config, cell.traffic
    batches, order = traffic.offline_batches(mix, spec['data'], seed)
    sampled = traffic.sample(seed, range(len(order)), mix['sampled_batches'])
    out = []
    for i in sampled:
        b = batches[order[i % len(order)]]
        out.append((serving.normalized(b['image'], b['img_hw'],
                                       spec['model']['img_mean'],
                                       spec['model']['img_std']),
                    b['img_hw'], b['scale_factor']))
    return out
