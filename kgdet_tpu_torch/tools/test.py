"""Inference + evaluation CLI (parity surface: reference tools/test.py).

Port of kgdet_tpu/tools/test.py, on the CUDA card unless ``--device`` says
otherwise:

  python -m kgdet_tpu_torch.tools.test \
      configs/kgdet_moment_r50_fpn_1x_demo.py \
      [--checkpoint work_dirs/x/checkpoints/16 | --load-pth KGDet_epoch-12.pth] \
      [--json-out results] \
      [--eval bbox keypoints] [--batch-size N] [--aug ...] [--device cpu]

Emits {json_out}.bbox.json / {json_out}.keypoints.json in the reference's
results2json format, scores them with the DeepFashion2 COCO evaluator and
prints the ``bbox_mAP_copypaste:`` / ``keypoints_mAP_copypaste:`` lines.
Without ``--checkpoint`` or ``--load-pth`` the model has the config's
seeded random weights.
``main(argv)`` runs in-process and returns the stats, the JSON files, the
per-image results and the timings (seconds of setup, inference and
evaluation, and run_inference's own).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='Test KGDet (PyTorch port)')
    p.add_argument('config')
    p.add_argument('--checkpoint', default=None,
                   help='a checkpoint of the port: a step of tools/train.py '
                        '(work_dir/checkpoints/<step>) or a params-only '
                        'save (tools/publish_model.py)')
    p.add_argument('--load-pth', default=None,
                   help='PyTorch .pth checkpoint to evaluate')
    p.add_argument('--json-out', default=None)
    p.add_argument('--eval', nargs='*', default=['bbox', 'keypoints'],
                   choices=['bbox', 'keypoints', 'segm', 'proposal_fast'])
    p.add_argument('--proposal-nums', type=int, nargs='*',
                   default=[100, 300, 1000],
                   help='AR@N cuts for proposal_fast (RPN) evaluation')
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--aug', action='store_true',
                   help='multi-scale/flip test-time augmentation (merge '
                        'raw boxes across variants before one NMS; bbox '
                        'eval only)')
    p.add_argument('--aug-scales', type=int, nargs='*', default=None,
                   help='flat (long short) pairs, e.g. 1333 800 667 400')
    p.add_argument('--no-aug-flip', action='store_true')
    p.add_argument('--distributed', action='store_true')
    p.add_argument('--device', default=None,
                   help='torch device; default the CUDA card (an error '
                        'where there is none)')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.distributed:
        raise NotImplementedError(
            '--distributed: multi-GPU evaluation is not ported yet (ROADMAP '
            'Queue 1 item 4)')

    from kgdet_tpu_torch.api import init_detector, resolve_device
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.eval_loop import evaluate_results, infer_dataset

    t_start = time.perf_counter()
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    model = init_detector(cfg, args.checkpoint, pth=args.load_pth,
                          device=device).model

    dataset = DeepFashion2Dataset(cfg.val_data, train=False)
    print(f'[test] {len(dataset)} images on {device}', flush=True)
    timings = {'setup_s': time.perf_counter() - t_start}
    scales = None
    if args.aug_scales:
        pairs = args.aug_scales
        scales = [tuple(pairs[i:i + 2]) for i in range(0, len(pairs), 2)]
    # four loader threads, the loader's default, as the JAX package's CLI
    results, eval_types = infer_dataset(
        model, cfg, dataset, batch_size=args.batch_size, num_workers=4,
        tta=args.aug, tta_scales=scales, tta_flip=not args.no_aug_flip,
        timings=timings)
    if not args.aug:
        eval_types = tuple(args.eval)
    out = {'results': results, 'timings': timings}
    if cfg.detector_type == 'rpn' or 'proposal_fast' in eval_types:
        # standalone RPN: proposal recall instead of mAP
        # (reference tools/test.py --eval proposal_fast + recall.py)
        from kgdet_tpu_torch.eval.recall import eval_proposal_recall
        rstats = eval_proposal_recall(results, dataset,
                                      proposal_nums=args.proposal_nums)
        line = ' '.join(f'{rstats[f"AR@{n}"]:.4f}'
                        for n in args.proposal_nums)
        print(f'proposal_AR_copypaste: {line}')
        return {**out, 'stats': {'proposal_fast': rstats}, 'files': {}}
    t_eval = time.perf_counter()
    timings['infer_s'] = t_eval - t_start - timings['setup_s']
    stats, files = evaluate_results(
        results, dataset,
        out_prefix=args.json_out or os.path.join(tempfile.gettempdir(),
                                                 'kgdet_test'),
        iou_types=eval_types)
    timings['eval_s'] = time.perf_counter() - t_eval
    timings['wall_s'] = time.perf_counter() - t_start
    for iou_type, s in stats.items():
        line = ' '.join(f'{v:.4f}' for k, v in s.items())
        print(f'{iou_type}_mAP_copypaste: {line}')
    print(f'[test] wrote {files}')
    return {**out, 'stats': stats, 'files': files}


if __name__ == '__main__':
    main()
