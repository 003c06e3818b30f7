"""Dataset-level inference + COCO bbox / keypoint / segm evaluation.

Port of kgdet_tpu/eval_loop.py. Inference runs in canvas-bucketed batches
(one predict function per canvas), the detections are copied to the host,
unpadded by ``valid`` and deduped by image id (the grouped loader wrap-pads
partial batches), converted to COCO JSON and scored by the NumPy
DeepFashion2 evaluator (294-sigma OKS). The loader's threads do host NumPy
work only; every tensor op runs in the caller's thread on the model's
device. In a process group each process infers its stride of the batches,
the results are gathered onto every process and every process scores them,
as the JAX package's run_eval does, so that none waits in a collective
while another scores; process 0 alone writes the JSON files. The mask
families' detections carry their mask probabilities, which segm scoring
pastes into the images on the host (models/mask_head.py::paste_masks)
and encodes as RLE (native/).
"""
from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from kgdet_tpu_torch.api import make_predict_fn, make_raw_predict_fn
from kgdet_tpu_torch.config import KGDetConfig
from kgdet_tpu_torch.data.loader import DataLoader
from kgdet_tpu_torch.eval.cocoeval import CocoEvaluator
from kgdet_tpu_torch.eval.json_writer import (detections_to_json,
                                              write_results)
from kgdet_tpu_torch.parallel.dist import world


def make_predict_fns(model, cfg: KGDetConfig, canvases):
    """One predict function per canvas bucket (api.make_predict_fn)."""
    return {tuple(c): make_predict_fn(model, cfg, tuple(c))
            for c in canvases}


def make_raw_predict_fns(model, cfg: KGDetConfig, canvases):
    """Per-canvas pre-NMS decode (raw boxes / scores) for TTA."""
    return {tuple(c): make_raw_predict_fn(model, cfg, tuple(c))
            for c in canvases}


class TTAVariant:
    """Dataset view emitting one (img_scale, flip) test variant
    (reference custom.py prepare_test_img:316-381 builds these inline)."""

    def __init__(self, base, img_scale=None, flip=False):
        self.base = base
        self.img_scale = tuple(img_scale) if img_scale else None
        self.flip = flip
        self.flags = base.flags

    def __len__(self):
        return len(self.base)

    def prepare_test(self, idx):
        return self.base.prepare_test(idx, flip=self.flip,
                                      img_scale=self.img_scale)


def _host(t):
    return t.cpu().numpy()


def run_inference_tta(model, cfg: KGDetConfig, dataset, scales=None,
                      flip=True, batch_size=None, verbose: bool = True):
    """Multi-scale/flip TTA over a dataset: each image's raw decoded boxes
    are merged across variants BEFORE one multiclass NMS, the reference's
    aug_test merge order (reppoints_detector_kp.py:93-148). Boxes only;
    keypoints are zeroed like the reference's aug path. A variant whose
    images outgrow every configured canvas gets its predict function built
    on first use."""
    from kgdet_tpu_torch.core.postprocess import nms_detections

    rank, world_size = world()
    scales = [tuple(s) for s in scales] if scales \
        else [tuple(cfg.val_data.img_scale)]
    variants = [(s, f) for s in scales
                for f in ((False, True) if flip else (False,))]
    fns = make_raw_predict_fns(model, cfg, cfg.val_data.canvas_hw)
    per_img_boxes: Dict[int, list] = {}
    per_img_scores: Dict[int, list] = {}
    t0 = time.time()
    for scale, f in variants:
        view = TTAVariant(dataset, img_scale=scale, flip=f)
        loader = DataLoader(
            view, batch_size or max(cfg.val_data.batch_size, 1),
            train=False, num_workers=2, num_shards=world_size, shard_id=rank)
        seen = set()
        for batch in loader:
            canvas = tuple(batch['image'].shape[1:3])
            fn = fns.get(canvas)
            if fn is None:
                fn = fns[canvas] = make_raw_predict_fn(model, cfg, canvas)
            bboxes, scores, _ = fn(batch)
            bb, sc = _host(bboxes), _host(scores)
            for i, img_id in enumerate(batch['img_id'].tolist()):
                if img_id in seen:
                    continue
                seen.add(img_id)
                b = bb[i]
                if f:
                    # flip-back: x' = (w_resized - 1)/sf - x, swap x1/x2
                    # (bbox_mapping_back: flip in resized coords, /sf)
                    lim = (batch['img_hw'][i][1] - 1) / \
                        batch['scale_factor'][i]
                    b = b.copy()
                    b[:, [0, 2]] = lim - b[:, [2, 0]]
                per_img_boxes.setdefault(img_id, []).append(b)
                per_img_scores.setdefault(img_id, []).append(sc[i])
        if verbose:
            print(f'[tta] scale={scale} flip={f}: '
                  f'{len(seen)} imgs, {time.time() - t0:.1f}s', flush=True)

    dev = next(model.parameters()).device
    K3 = cfg.head.num_keypts * 3
    results: Dict[int, tuple] = {}
    with torch.inference_mode():
        for img_id, blist in per_img_boxes.items():
            boxes = torch.from_numpy(np.concatenate(blist))[None].to(dev)
            scores = torch.from_numpy(
                np.concatenate(per_img_scores[img_id]))[None].to(dev)
            kpts = boxes.new_zeros(boxes.shape[:2] + (K3,))
            dets = nms_detections(boxes, scores, kpts, cfg.test)
            v = _host(dets['valid'][0])
            results[img_id] = (_host(dets['det_bboxes'][0])[v],
                               _host(dets['det_labels'][0])[v],
                               _host(dets['det_kpts'][0])[v])
    return results


def run_inference(model, cfg: KGDetConfig, loader: DataLoader,
                  verbose: bool = True, timings: Optional[dict] = None):
    """Run the detector over a test loader; returns {img_id: detections}.

    Detections are (dets (N, 5), labels (N,), kpts (N, K*3)) numpy tuples in
    original-image coordinates, deduped by img_id; the mask families add
    their (N, S, S) mask probabilities and Mask Scoring R-CNN its (N,) mask
    scores (4- and 5-tuples). A batch whose canvas has
    no predict function raises KeyError. ``timings``, where given, gathers
    the seconds spent waiting for batches (``data_s``) and in predict plus
    the copy to the host (``predict_s``), and the batches and images seen.
    """
    predict_fns = make_predict_fns(model, cfg, cfg.val_data.canvas_hw)
    results: Dict[int, tuple] = {}
    clock = {'data_s': 0.0, 'predict_s': 0.0, 'batches': 0, 'images': 0}
    t0 = time.time()
    n_done = 0
    batches = iter(loader)
    while True:
        t_wait = time.perf_counter()
        batch = next(batches, None)
        t_got = time.perf_counter()
        if batch is None:
            break
        canvas = tuple(batch['image'].shape[1:3])
        if canvas not in predict_fns:
            raise KeyError(f'no predict fn for canvas {canvas}; '
                           f'have {list(predict_fns)}')
        dets = predict_fns[canvas](batch)
        det_bboxes = _host(dets['det_bboxes'])
        det_labels = _host(dets['det_labels'])
        det_kpts = _host(dets['det_kpts'])
        extra = [_host(dets[k]) for k in ('det_masks', 'det_mask_scores')
                 if k in dets]
        valid = _host(dets['valid'])
        clock['data_s'] += t_got - t_wait
        clock['predict_s'] += time.perf_counter() - t_got
        clock['batches'] += 1
        clock['images'] += len(batch['img_id'])
        for i, img_id in enumerate(batch['img_id'].tolist()):
            if img_id in results:
                continue
            v = valid[i]
            results[img_id] = tuple(t[i][v] for t in (
                det_bboxes, det_labels, det_kpts, *extra))
            n_done += 1
        if verbose:
            dt = time.time() - t0
            print(f'\r[eval] {n_done} imgs, {n_done / max(dt, 1e-6):.1f} '
                  f'img/s', end='', flush=True)
    if verbose:
        print()
    if timings is not None:
        timings.update(clock)
    return results


def gather_results_across_processes(results: Dict[int, tuple]):
    """The results of every process merged into one dict on every process
    (``dist.all_gather_object``; an image inferred by two processes, as a
    wrap-padded batch's repeat, keeps the later process's detections, as
    kgdet_tpu/eval_loop.py:232-258 merges them); the identity for one
    process."""
    if world()[1] == 1:
        return results
    import torch.distributed as dist
    gathered = [None] * world()[1]
    dist.all_gather_object(gathered, results)
    merged: Dict[int, tuple] = {}
    for part in gathered:
        merged.update(part)
    return merged


def evaluate_results(results: Dict[int, tuple], dataset,
                     out_prefix: Optional[str] = None,
                     iou_types=('bbox', 'keypoints'), verbose: bool = True,
                     write: bool = True):
    """results -> COCO JSON -> AP stats dict (parity: coco_utils.coco_eval).
    The JSON files go to ``out_prefix``.{bbox,keypoints,segm}.json, by
    default under the temporary directory, where ``write`` (process 0 of a
    group); the scores are taken from the same lists in memory, so a
    process that writes nothing returns the same (stats, files)."""
    img_ids = sorted(results.keys())
    per_img = [results[i][:3] for i in img_ids]
    if out_prefix is None:
        out_prefix = os.path.join(tempfile.gettempdir(), 'kgdet_eval')
    dets = dict(zip(('bbox', 'keypoints'),
                    detections_to_json(per_img, img_ids, dataset.cat_ids)))
    if 'segm' in iou_types:
        dets['segm'] = segm_json(results, img_ids, dataset)
    files = {k: f'{out_prefix}.{k}.json' for k in dets}
    if write:
        os.makedirs(os.path.dirname(os.path.abspath(out_prefix)),
                    exist_ok=True)
        write_results(dets, files)

    stats = {}
    for iou_type in iou_types:
        dt = dataset.coco.load_results(
            dets[iou_type if iou_type in dets else 'keypoints'])
        ev = CocoEvaluator(dataset.coco, dt, iou_type)
        ev.params.img_ids = img_ids
        ev.evaluate()
        ev.accumulate()
        stats[iou_type] = ev.summarize(verbose=verbose)
    return stats, files


def segm_json(results, img_ids, dataset):
    """The segm result list: each detection's mask probabilities pasted
    at its box in the original image and RLE-encoded (parity:
    fcn_mask_head.get_seg_masks + segm2json). The score is the box's, or
    Mask Scoring R-CNN's mask score where the result carries one (a
    5-tuple); results without masks (3-tuples) add nothing."""
    from kgdet_tpu_torch.models.mask_head import paste_masks
    from kgdet_tpu_torch.native import RLE
    out = []
    for img_id in img_ids:
        entry = results[img_id]
        if len(entry) < 4:
            continue
        dets, labels, _, masks = entry[:4]
        scores = entry[4] if len(entry) > 4 else dets[:, 4]
        info = dataset.coco.imgs[img_id]
        h, w = info['height'], info['width']
        for i, full in enumerate(paste_masks(dets, masks, h, w)):
            out.append({
                'image_id': int(img_id),
                'category_id': int(dataset.cat_ids[int(labels[i])]),
                'score': round(float(scores[i]), 4),
                'segmentation': {'size': [h, w], 'counts':
                                 RLE.encode(full).to_string().decode()},
            })
    return out


def infer_dataset(model, cfg: KGDetConfig, dataset,
                  batch_size: Optional[int] = None, num_workers: int = 2,
                  verbose: bool = True, tta: bool = False, tta_scales=None,
                  tta_flip: bool = True, timings: Optional[dict] = None):
    """The detections of every image of ``dataset`` and the COCO types to
    score them by: (results, iou_types). tta=True runs dataset-level
    multi-scale/flip test-time augmentation (merge raw boxes across
    variants, one NMS; boxes only); otherwise ``timings`` goes to
    run_inference."""
    if tta:
        results = run_inference_tta(
            model, cfg, dataset, scales=tta_scales, flip=tta_flip,
            batch_size=batch_size, verbose=verbose)
        iou_types = ('bbox',)
    else:
        rank, world_size = world()
        loader = DataLoader(
            dataset, batch_size or max(cfg.val_data.batch_size, 1),
            train=False, num_workers=num_workers, num_shards=world_size,
            shard_id=rank)
        results = run_inference(model, cfg, loader, verbose=verbose,
                                timings=timings)
        iou_types = ('bbox', 'keypoints')
    return gather_results_across_processes(results), iou_types


def run_eval(model, cfg: KGDetConfig, dataset,
             batch_size: Optional[int] = None, out_prefix=None,
             num_workers: int = 2, verbose: bool = True,
             tta: bool = False, tta_scales=None, tta_flip: bool = True):
    """Full inference + evaluation pipeline; returns (AP stats, files),
    the same on every process (process 0 alone prints and writes)."""
    lead = world()[0] == 0
    verbose = verbose and lead
    results, iou_types = infer_dataset(
        model, cfg, dataset, batch_size=batch_size, num_workers=num_workers,
        verbose=verbose, tta=tta, tta_scales=tta_scales, tta_flip=tta_flip)
    return evaluate_results(results, dataset, out_prefix,
                            iou_types=iou_types, verbose=verbose, write=lead)
