"""Robustness benchmark: mAP under image corruptions.

Port of kgdet_tpu/tools/test_robustness.py (parity surface: reference
tools/test_robustness.py): the clean validation set and each corruption x
severity of it (data/corruptions.py, applied to each image as it is read)
go through eval_loop.run_inference / evaluate_results; prints each one's
AP and the mean over the corruptions. On the CUDA card unless
``--device`` says otherwise:

  python -m kgdet_tpu_torch.tools.test_robustness configs/..._demo.py \
      [--checkpoint CKPT | --load-pth PTH] \
      [--corruptions gaussian_noise motion_blur] [--severities 1 3 5] \
      [--eval bbox] [--out table.json] [--device cpu]

``main(argv)`` also returns the table ({'clean' | '<name>/s<sev>':
{iou_type: AP}}) and the number of batches inferred.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--load-pth', default=None)
    p.add_argument('--corruptions', nargs='+', default=None,
                   help='default: all')
    p.add_argument('--severities', type=int, nargs='+', default=[1, 3, 5])
    p.add_argument('--eval', nargs='+', default=['bbox'])
    p.add_argument('--out', default=None, help='write results json')
    p.add_argument('--device', default=None,
                   help='torch device; default the CUDA card, an error '
                        'where there is none')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from kgdet_tpu_torch.api import init_detector
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.data.corruptions import CORRUPTIONS, corrupt
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.data.loader import DataLoader
    from kgdet_tpu_torch.eval_loop import evaluate_results, run_inference

    cfg = load_config(args.config)
    # the .pth first, then the checkpoint, as the JAX tool loads them
    model = init_detector(cfg, checkpoint=args.checkpoint,
                          pth=args.load_pth, device=args.device).model

    corruptions = args.corruptions or sorted(CORRUPTIONS)
    results_table = {}

    class CorruptedDataset(DeepFashion2Dataset):
        corruption = None
        severity = 1

        def load_image(self, record):
            img = super().load_image(record)
            if self.corruption:
                img = corrupt(img, self.corruption, self.severity)
            return img

    dataset = CorruptedDataset(cfg.val_data, train=False)
    batch = max(cfg.val_data.batch_size, 1)
    batches = [0]

    def eval_once(tag):
        loader = DataLoader(dataset, batch, train=False, num_workers=2)
        timings = {}
        results = run_inference(model, cfg, loader, verbose=False,
                                timings=timings)
        batches[0] += timings['batches']
        stats, _ = evaluate_results(results, dataset, verbose=False,
                                    iou_types=tuple(args.eval), write=False)
        aps = {t: s['AP'] for t, s in stats.items()}
        print(f'{tag}: ' + ' '.join(f'{t} AP {v:.4f}'
                                    for t, v in aps.items()), flush=True)
        return aps

    dataset.corruption = None
    results_table['clean'] = eval_once('clean')
    for name in corruptions:
        for sev in args.severities:
            dataset.corruption = name
            dataset.severity = sev
            results_table[f'{name}/s{sev}'] = eval_once(f'{name} s{sev}')

    for t in args.eval:
        vals = [v[t] for k, v in results_table.items() if k != 'clean']
        if vals:
            print(f'mean corruption {t} AP: {np.mean(vals):.4f} '
                  f'(clean {results_table["clean"][t]:.4f})')
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(results_table, f, indent=1)
        print(f'wrote {args.out}')
    return results_table, batches[0]


if __name__ == '__main__':
    main()
