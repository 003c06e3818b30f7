"""Interactive serving: single-image requests arrive as a Poisson process at
the mix's fixed rate (an open loop) and one server takes them in arrival
order through the program's ``api.Detector.__call__``: host rescale,
normalize and pad, a batch-1 ``predict``, the host's filter of the valid
detections.

Each request is timed from when it was due to when its result is on the
host, so a stall also delays the requests queued behind it. Every request
due in the window is served, the last after the window's end.
``online_img_s`` is the requests completed inside the window over its
seconds: the served rate, where the mix offers more than the server
sustains. ``serve_p95_ms`` is the 95th percentile of all their latencies,
the end-to-end metric of a mix below the server's capacity. The
generator's lateness, how far after its due time a request reached an
idle server, is printed on standard error. With tracing, ``traced_requests`` more requests
are served back to back, with stage spans, under the profiler. Then the
program is freed and the sampled requests' head outputs and detections are
held against the plain reference, which repeats the host preprocessing
itself.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from kgbench import check, serving, traffic


def run(cell, seed, seconds, trace, t0, device):
    from kgdet_tpu_torch.api import Detector
    spec, mix = cell.config, cell.traffic
    cfg, w, ref, model = serving.setup(cell, seed, device)
    detector = Detector(cfg, model)
    images, due, which = traffic.open_loop(mix, seed, seconds)
    sizes = [im.shape[:2] for im in images]
    # warm-up: every pool image once (both canvases), then the first again
    for im in images + images[:1]:
        detector(im)
    cap = serving.Capture(model)
    largest = max(range(len(due)), key=lambda j: np.prod(sizes[which[j]]))
    sampled = set(traffic.sample(seed, range(len(due)),
                                 mix['sampled_requests'], always=[largest]))
    serving.reset_peak(device)
    setup_s = time.perf_counter() - t0

    start = time.perf_counter()
    timed = open_loop(due, lambda j: (detector(images[which[j]]), cap.last),
                      start, keep=sampled)
    elapsed = time.perf_counter() - start
    peak = serving.peak_bytes(device)
    late = timed['late_s']
    print(f'generator lateness: mean {np.mean(late) * 1e3 if late else 0:.4f}'
          f' ms, max {max(late, default=0) * 1e3:.4f} ms over {len(late)} '
          f'requests that found the server idle, of {len(due)}; service '
          f'median {1e3 * np.median(timed["service_s"]):.3f} ms, wait mean '
          f'{1e3 * np.mean(timed["wait_s"]):.3f} ms',
          file=sys.stderr)
    kept = {j: (serving.head_to_cpu(heads), out)
            for j, (out, heads) in timed['outputs'].items()}
    obs = {'requests': len(due), 'seconds': elapsed,
           'wait_s': timed['wait_s'], 'service_s': timed['service_s'],
           'latency_s': timed['latency_s'], 'model': spec['model']}
    if trace:
        k = [0]

        def one():
            detector(images[k[0] % len(images)])
            k[0] += 1
        obs['timeline'], obs['stage_ms'] = serving.traced_stretch(
            model, one, mix['traced_requests'])
    cap.close()
    del model, detector, cap
    serving.free()

    items = []
    for j in sorted(kept):
        outs, (boxes, labels, kpts) = kept[j]
        img = images[which[j]]
        x, img_hw, sf = ref_input(spec, img)
        items.append((x, outs, [(boxes, labels, kpts.reshape(len(kpts), -1))],
                      img_hw, sf))
    readings = serving.reference_gaps(
        ref, cell.module('reference', spec['decode']), spec,
        {'weights': w, 'items': items}, device)
    correct, rows = check.judge(readings, spec['limits'])
    failed = timed['failed']
    correct = correct and failed == 0 and len(kept) == len(sampled)
    return {'correct': correct, 'attempted': len(due), 'failed': failed,
            'e2e': {'serve_p95_ms': 1e3 * float(np.percentile(
                timed['latency_s'], 95)),
                    'online_img_s': sum(
                        t <= seconds for t in timed['done_s']) / seconds,
                    'peak_mem_gib': peak / 2 ** 30, 'setup_s': setup_s},
            'obs': obs, 'checks': rows, 'peak_bytes': peak}


def open_loop(due, serve_one, start, keep=()):
    """Serves request j = 0, 1, ... once ``start + due[j]`` has come, one at
    a time in arrival order. Each is timed from its due time: latency to its
    result, its wait to the start of its service, its service; a request
    that raises is a failure, with an infinite latency. ``late_s``: how far
    past its due time each request that found the server idle began;
    ``done_s``: when each completed, from ``start``. ``outputs``: the
    results of the requests of ``keep``."""
    lat, wait, service, late, done, outputs = [], [], [], [], [], {}
    failed = 0
    for j, d in enumerate(due):
        t_due = start + d
        idle = time.perf_counter() < t_due
        serving.wait_until(t_due)
        t_begin = time.perf_counter()
        if idle:
            late.append(t_begin - t_due)
        try:
            out = serve_one(j)
        except Exception as e:          # a failed request counts as missing
            print(f'kgbench: request {j} failed: {e!r}', file=sys.stderr)
            failed += 1
            lat.append(float('inf'))
            continue
        t_end = time.perf_counter()
        lat.append(t_end - t_due)
        wait.append(t_begin - t_due)
        service.append(t_end - t_begin)
        done.append(t_end - start)
        if j in keep:
            outputs[j] = out
    return {'latency_s': lat, 'wait_s': wait, 'service_s': service,
            'late_s': late, 'done_s': done, 'failed': failed,
            'outputs': outputs}


def ref_input(spec, img):
    """The reference's own preprocessing of one BGR uint8 request: keep-ratio
    bilinear resize, normalize, zero pad to the smallest canvas -> (x
    (1, 3, H, W), img_hw (1, 2), scale_factor (1,)), float32."""
    from kgbench.reference import preprocess
    data, m = spec['data'], spec['model']
    rh, rw, sf = traffic.keep_ratio(*img.shape[:2], data['img_scale'])
    canvas = traffic.canvas_for(data['canvases'], rh, rw)
    x = preprocess.resize_bilinear_u8(img, rh, rw)
    x = serving.normalized(preprocess.pad(x, canvas)[None], [[rh, rw]],
                           m['img_mean'], m['img_std'])
    return x, np.array([[rh, rw]], np.float32), np.array([sf], np.float32)


def control_readings(cell, seed, device):
    return serving.control_readings(cell, control_inputs(cell, seed), seed,
                                    device)


def control_inputs(cell, seed):
    """The reference inputs of as many requests as a run samples, the
    largest source image among them, for the control."""
    mix = cell.traffic
    images, _, _ = traffic.open_loop(mix, seed, 1.0)
    largest = max(range(len(images)), key=lambda i: images[i].size)
    return [ref_input(cell.config, images[i]) for i in traffic.sample(
        seed, range(len(images)), mix['sampled_requests'], always=[largest])]
