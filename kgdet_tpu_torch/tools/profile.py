"""Profiler CLI: a torch.profiler Chrome trace of the served batch or the
train step.

Port of kgdet_tpu/tools/profile.py (the reference has no tracer; the JAX
tool writes a jax.profiler trace). ``--mode infer`` traces the served
batch through eval_loop's predict function (forward, decode and NMS),
``--mode train`` the train step (forward, loss, backward, the update), on
synthetic inputs of the config's first validation canvas and the model's
seeded random weights. One warm-up run happens outside the trace, as the
JAX tool compiles outside it. The trace (``<trace-dir>/trace.json``) opens
in Perfetto or chrome://tracing; on the card the port's kernels appear as
their device kernels (``kgdet::...``), on the CPU their plain versions as
ranges named after them (``K1 deform_conv_fused``, ...). A span recording
(utils/trace.py) is open around the traced runs, so the program's spans
appear as host ranges ``kgdet.<span>``: ``kgdet.predict``,
``kgdet.forward``, ``kgdet.decode``, ... or ``kgdet.step``,
``kgdet.loss``, ``kgdet.backward``, ``kgdet.optimizer``. On the CUDA card
unless ``--device`` says otherwise:

  python -m kgdet_tpu_torch.tools.profile configs/..._demo.py \
      --mode infer [--trace-dir DIR] [--steps 5] [--batch-size 1] \
      [--device cpu]

``main(argv)`` also returns the trace's path. ``device_profile(fn)``
counts what one call of ``fn`` puts on the card (the GPU tests and
chip_smoke.py read it).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def short_name(kernel):
    """A kernel of the port as the profiler names it, without namespaces
    and arguments but with its template arguments (the tile or the dtype)."""
    return kernel.replace('(anonymous namespace)::', '').split('(')[0] \
        .split('::')[-1]


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
    counted, and a recording counts when it holds the port's kernels and
    all device activities each in a multiple of ``reps`` (every call puts
    the same ones on the device), else it is taken again."""
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
        if own and len(own) % reps == 0 and len(dev) % reps == 0:
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
    raise RuntimeError('the profiler lost device records in five '
                       'recordings')


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('--mode', choices=['infer', 'train'], default='infer')
    p.add_argument('--trace-dir',
                   default=os.path.join(tempfile.gettempdir(),
                                        'kgdet_trace'))
    p.add_argument('--steps', type=int, default=5)
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--device', default=None,
                   help='torch device; default the CUDA card, an error '
                        'where there is none')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kgdet_tpu_torch.api import build_model, init_trainer, \
        resolve_device
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.eval_loop import make_predict_fns
    from kgdet_tpu_torch.utils.trace import recording

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    canvas = tuple(cfg.val_data.canvas_hw[0])
    B = args.batch_size
    rng = np.random.RandomState(0)

    if args.mode == 'infer':
        model = build_model(cfg, device='cpu').init_weights(cfg.seed)
        model = model.to(device).eval()
        predict = make_predict_fns(model, cfg, [canvas])[canvas]
        feed = {
            'image': torch.from_numpy(rng.randn(
                B, canvas[0], canvas[1], 3).astype(np.float32)),
            'img_hw': torch.tensor([[canvas[0] * 0.95, canvas[1] * 0.95]]
                                   ).repeat(B, 1),
            'scale_factor': torch.ones(B),
        }

        def run():
            return predict(feed)
    else:
        _, _, step = init_trainer(cfg, canvas, steps_per_epoch=1000,
                                  device=device)
        G, K = cfg.train_data.max_gts, cfg.head.num_keypts
        batch = {
            'image': rng.randn(B, canvas[0], canvas[1], 3).astype(
                np.float32),
            'valid_hw': np.full((B, 2), canvas[0], np.int32),
            'gt_bboxes': np.tile(np.asarray(
                [[10., 10., 200., 200.]], np.float32), (B, G, 1)),
            'gt_labels': np.ones((B, G), np.int32),
            'gt_kpts': rng.rand(B, G, K, 3).astype(np.float32) * 100,
            'gt_mask': np.ones((B, G), bool),
        }

        def run():
            return step(batch)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    run()                           # warm-up (kernel builds) outside
    sync()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    with profile(activities=activities) as prof, recording():
        for _ in range(args.steps):
            run()
        sync()
    os.makedirs(args.trace_dir, exist_ok=True)
    path = os.path.join(args.trace_dir, 'trace.json')
    prof.export_chrome_trace(path)
    print(f'trace written to {path}')
    return path


if __name__ == '__main__':
    main()
