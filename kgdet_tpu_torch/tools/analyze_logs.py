"""Training-log analysis (parity: reference tools/analyze_logs.py).

The port's copy of kgdet_tpu/tools/analyze_logs.py: the port's runner
writes the JAX package's records, so both tools print the same on one file.
Reads the runner's train_log.jsonl and reports per-epoch timing statistics or
loss-curve summaries.

Usage:
  python -m kgdet_tpu_torch.tools.analyze_logs cal_train_time work_dirs/x/train_log.jsonl
  python -m kgdet_tpu_torch.tools.analyze_logs plot_curve work_dirs/x/train_log.jsonl \
      --keys loss loss_cls_3 [--out curve.png]
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def load_log(path):
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


def cal_train_time(recs):
    train = [r for r in recs if r.get('mode') == 'train'
             and r.get('imgs_per_sec', 0) > 0]
    if not train:
        print('no timed train records')
        return
    by_epoch = {}
    for r in train:
        by_epoch.setdefault(r['epoch'], []).append(r['imgs_per_sec'])
    for e in sorted(by_epoch):
        v = np.asarray(by_epoch[e])
        print(f'epoch {e}: imgs/s mean {v.mean():.1f}, '
              f'min {v.min():.1f}, max {v.max():.1f}, n={len(v)}')
    allv = np.asarray([x for v in by_epoch.values() for x in v])
    print(f'overall: imgs/s mean {allv.mean():.1f} +/- {allv.std():.1f}')


def plot_curve(recs, keys, out=None):
    train = [r for r in recs if r.get('mode') == 'train']
    for k in keys:
        ys = [r[k] for r in train if k in r]
        if not ys:
            print(f'{k}: no records')
            continue
        ys = np.asarray(ys)
        print(f'{k}: first {ys[0]:.4f}, last {ys[-1]:.4f}, '
              f'min {ys.min():.4f}, max {ys.max():.4f}, n={len(ys)}')
    if out:
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(8, 5))
        for k in keys:
            ys = [r[k] for r in train if k in r]
            ax.plot(ys, label=k)
        ax.set_xlabel('log step')
        ax.legend()
        fig.savefig(out, dpi=120)
        print(f'wrote {out}')


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('task', choices=['cal_train_time', 'plot_curve'])
    p.add_argument('log')
    p.add_argument('--keys', nargs='+', default=['loss'])
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    recs = load_log(args.log)
    if args.task == 'cal_train_time':
        cal_train_time(recs)
    else:
        plot_curve(recs, args.keys, args.out)


if __name__ == '__main__':
    main()
