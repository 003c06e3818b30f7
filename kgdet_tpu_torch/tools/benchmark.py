"""Inference speed benchmark (the reference tools/benchmark.py protocol).

Port of kgdet_tpu/tools/benchmark.py: end-to-end fps of the predict
function (forward + decode + NMS) over the dataset's images of the first
canvas, or a synthetic feed, after a warm-up, with the device synchronized
before and after the timed loop. On the CUDA card unless ``--device`` says
otherwise:

  python -m kgdet_tpu_torch.tools.benchmark configs/..._demo.py \
      [--checkpoint CKPT] [--num-images 2000] [--warmup 5] \
      [--batch-size 1] [--synthetic] [--device cpu]

Without ``--checkpoint`` (a checkpoint of the port, as tools/test.py
--checkpoint reads it) the model has the config's seeded random weights.
Every config the port builds runs, the two-stage ones included; Fast
R-CNN's synthetic feed carries ``val_data.num_proposals`` random boxes an
image as its proposals.
Prints ``Overall fps: ...``; ``main(argv)`` also returns the numbers.
"""
from __future__ import annotations

import argparse
import time

FEED_KEYS = ('image', 'img_hw', 'scale_factor', 'proposals',
             'proposals_valid')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Benchmark KGDet inference '
                                            '(PyTorch port)')
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--num-images', type=int, default=2000)
    p.add_argument('--warmup', type=int, default=5)
    p.add_argument('--batch-size', type=int, default=1)
    p.add_argument('--synthetic', action='store_true',
                   help='use random tensors instead of dataset images '
                        '(isolates device time from host decode)')
    p.add_argument('--device', default=None,
                   help='torch device; default the CUDA card, an error '
                        'where there is none')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from kgdet_tpu_torch.api import init_detector, resolve_device
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.eval_loop import make_predict_fns

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    model = init_detector(cfg, args.checkpoint, device=device).model
    canvas = tuple(cfg.val_data.canvas_hw[0])
    predict = make_predict_fns(model, cfg, [canvas])[canvas]
    B = args.batch_size
    rng = np.random.RandomState(0)

    def on_device(feed):
        return {k: torch.as_tensor(np.asarray(v)).to(device)
                for k, v in feed.items() if k in FEED_KEYS}

    def synth_feed():
        feed = {
            'image': rng.randn(B, canvas[0], canvas[1], 3).astype(
                np.float32),
            'img_hw': np.tile(np.asarray(
                [[canvas[0] * 0.95, canvas[1] * 0.95]], np.float32), (B, 1)),
            'scale_factor': np.ones((B,), np.float32),
        }
        if cfg.detector_type == 'fast_rcnn':
            # Fast R-CNN's input proposals: random boxes inside the image
            n = cfg.val_data.num_proposals
            xy = rng.uniform(0, 0.8, (B, n, 2)) * canvas[::-1]
            wh = rng.uniform(0.05, 0.2, (B, n, 2)) * canvas[::-1]
            feed['proposals'] = np.concatenate([xy, xy + wh], -1) \
                .astype(np.float32)
            feed['proposals_valid'] = np.ones((B, n), bool)
        return on_device(feed)

    feeds = []
    if not args.synthetic:
        from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
        from kgdet_tpu_torch.data.loader import DataLoader
        ds = DeepFashion2Dataset(cfg.val_data, train=False)
        for b in DataLoader(ds, B, train=False, num_workers=2):
            if tuple(b['image'].shape[1:3]) != canvas:
                continue
            feeds.append(on_device(b))
            if len(feeds) * B >= args.num_images:
                break
    if not feeds:
        feeds = [synth_feed()]

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    # warm-up: cuDNN plans, the allocator, the kernels' first launch
    predict(feeds[0])
    sync()
    for i in range(args.warmup):
        predict(feeds[i % len(feeds)])
    sync()

    n_iters = max(args.num_images // B, 1)
    t0 = time.perf_counter()
    for i in range(n_iters):
        predict(feeds[i % len(feeds)])
    sync()
    dt = time.perf_counter() - t0
    fps = n_iters * B / dt
    print(f'Overall fps: {fps:.1f} img/s ({dt / n_iters * 1e3:.2f} ms/iter, '
          f'batch {B}, canvas {canvas}, {device})', flush=True)
    return {'fps': fps, 'ms_per_iter': dt / n_iters * 1e3, 'iters': n_iters,
            'batch_size': B, 'canvas': canvas, 'device': str(device)}


if __name__ == '__main__':
    main()
