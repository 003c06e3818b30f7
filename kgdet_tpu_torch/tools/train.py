"""Training CLI (parity surface: reference mmdetection/tools/train.py).

Port of kgdet_tpu/tools/train.py, on the CUDA card unless ``--device`` says
otherwise:

  python -m kgdet_tpu_torch.tools.train \
      configs/kgdet_moment_r50_fpn_1x_demo.py \
      [--work-dir DIR] [--resume] [--load-from CKPT | --load-pth PTH] \
      [--validate] [--seed N] [--max-epochs N] [--log-interval N] \
      [--autoscale-lr] [--device cpu]

Writes work_dir/train_log.jsonl, a checkpoint of the port an epoch under
work_dir/checkpoints/<step> (``--resume`` continues from the newest one;
``tools/test.py --checkpoint`` evaluates one) and, with ``--validate``,
work_dir/eval_epoch<N>.{bbox,keypoints}.json. ``main(argv)`` runs
in-process and returns the Runner. ``--distributed`` (several GPUs) is not
ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Train KGDet (PyTorch port)')
    p.add_argument('config', help='python config file defining `config`')
    p.add_argument('--work-dir', default=None)
    p.add_argument('--resume', action='store_true',
                   help='resume from the latest checkpoint in work_dir')
    p.add_argument('--load-from', default=None,
                   help='checkpoint of the port to initialize from (a '
                        'train-state step or a params-only save)')
    p.add_argument('--load-pth', default=None,
                   help='PyTorch .pth checkpoint to load (keys the model '
                        'lacks are skipped, parameters it lacks keep their '
                        'seeded values)')
    p.add_argument('--validate', action='store_true')
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--max-epochs', type=int, default=None)
    p.add_argument('--autoscale-lr', action='store_true',
                   help='scale lr by global_batch/16 (the reference scales '
                        'by GPUs/8 at 2 imgs/GPU; reference train.py:67)')
    p.add_argument('--log-interval', type=int, default=50)
    p.add_argument('--distributed', action='store_true')
    p.add_argument('--device', default=None,
                   help='torch device; default the CUDA card (an error '
                        'where there is none)')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            '--distributed: training on several GPUs is not ported yet '
            '(ROADMAP Queue 1 item 4)')

    from kgdet_tpu_torch.api import build_model
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.runner import Runner
    from kgdet_tpu_torch.utils.checkpoint import load_params

    cfg = load_config(args.config)
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.work_dir is not None:
        cfg = cfg.replace(work_dir=args.work_dir)
    if args.autoscale_lr:
        scale = cfg.train_data.batch_size / 16
        cfg = cfg.replace(optim=dataclasses.replace(
            cfg.optim, lr=cfg.optim.lr * scale))
        print(f'[train] autoscaled lr x{scale:g} -> {cfg.optim.lr:g}')

    init_state = None
    if args.load_pth:
        from kgdet_tpu_torch.utils.convert import load_pth
        model = build_model(cfg, device='cpu').init_weights(cfg.seed)
        res = model.load_state_dict(load_pth(args.load_pth), strict=False)
        if res.unexpected_keys:
            print(f'[convert] skipped {len(res.unexpected_keys)} keys: '
                  f'{res.unexpected_keys[:8]}...')
        init_state = model.state_dict()
    elif args.load_from:
        init_state = load_params(args.load_from)

    runner = Runner(cfg, work_dir=cfg.work_dir,
                    log_interval=args.log_interval, device=args.device)
    runner.setup(init_state_dict=init_state, resume=args.resume)
    print(f'[train] {len(runner.train_dataset)} images, '
          f'{runner.steps_per_epoch} steps/epoch, device {runner.device}',
          flush=True)
    runner.run(validate=args.validate, max_epochs=args.max_epochs)
    return runner


if __name__ == '__main__':
    main()
