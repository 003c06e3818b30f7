"""Offline evaluation of saved result JSONs (parity: reference
tools/coco_eval.py -> mmdet.core.coco_eval).

Port of kgdet_tpu/tools/coco_eval.py over the port's own evaluator
(eval/coco.py, eval/cocoeval.py); NumPy only, no device:

  python -m kgdet_tpu_torch.tools.coco_eval --result out.bbox.json \
      --ann val.json --types bbox
  python -m kgdet_tpu_torch.tools.coco_eval --result out.keypoints.json \
      --ann val.json --types keypoints [--max-dets 1 10 100]

``main(argv)`` also returns each type's stats.
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--result', required=True, nargs='+',
                   help='result json file(s), aligned with --types')
    p.add_argument('--ann', required=True, help='GT annotation json')
    p.add_argument('--types', nargs='+', default=['bbox'],
                   choices=['bbox', 'keypoints', 'segm'])
    p.add_argument('--max-dets', type=int, nargs='+', default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from kgdet_tpu_torch.eval.coco import CocoIndex
    from kgdet_tpu_torch.eval.cocoeval import CocoEvaluator

    gt = CocoIndex(args.ann)
    results = args.result
    if len(results) == 1 and len(args.types) > 1:
        results = results * len(args.types)
    stats = {}
    for res_file, iou_type in zip(results, args.types):
        print(f'=== {iou_type}: {res_file}')
        dt = gt.load_results(res_file)
        ev = CocoEvaluator(gt, dt, iou_type)
        if args.max_dets:
            ev.params.max_dets = list(args.max_dets)
        ev.evaluate()
        ev.accumulate()
        stats[iou_type] = ev.summarize(verbose=True)
    return stats


if __name__ == '__main__':
    main()
