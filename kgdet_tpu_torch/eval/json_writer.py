"""Convert detector outputs to COCO-format result JSON (bbox + keypoints).

Parity reference: the reference's mmdet/core/evaluation/
coco_utils.py:79-157 (xyxy2xywh with the legacy +1 convention, kpt2json with
4-digit rounding and keypoint score = box score).

The port's own copy of kgdet_tpu/eval/json_writer.py, NumPy and the stdlib
only.
"""
from __future__ import annotations

import json

import numpy as np


def xyxy2xywh(bbox):
    # legacy mmdet v1 convention: w = x2 - x1 + 1
    return [float(bbox[0]), float(bbox[1]),
            float(bbox[2] - bbox[0] + 1), float(bbox[3] - bbox[1] + 1)]


def detections_to_json(results, img_ids, cat_ids, num_digits=4):
    """Build (bbox_json, kpt_json) result lists.

    ``results`` is a list (per image) of tuples ``(dets, labels, kpts)``:
      dets: (N, 5) xyxy + score; labels: (N,) 0-based class; kpts: (N, K*3).
    ``img_ids`` aligns with ``results``; ``cat_ids`` maps 0-based label ->
    dataset category id.
    """
    bbox_json, kpt_json = [], []
    for img_id, (dets, labels, kpts) in zip(img_ids, results):
        dets = np.asarray(dets)
        labels = np.asarray(labels)
        kpts = np.asarray(kpts)
        for i in range(dets.shape[0]):
            score = round(float(dets[i, 4]), num_digits)
            cat = int(cat_ids[int(labels[i])])
            bbox_json.append({
                'image_id': int(img_id),
                'bbox': [round(v, num_digits) for v in xyxy2xywh(dets[i])],
                'score': score,
                'category_id': cat,
            })
            kpt_json.append({
                'image_id': int(img_id),
                'keypoints': np.round(
                    kpts[i].astype(np.float64), num_digits).tolist(),
                'score': score,
                'category_id': cat,
            })
    return bbox_json, kpt_json


def write_results(dets, files):
    """Each result list of ``dets`` (by COCO type) as JSON to its path in
    ``files``."""
    for kind, path in files.items():
        with open(path, 'w') as f:
            json.dump(dets[kind], f)


def dump_results(results, img_ids, cat_ids, out_prefix):
    bbox_json, kpt_json = detections_to_json(results, img_ids, cat_ids)
    dets = {'bbox': bbox_json, 'keypoints': kpt_json}
    files = {k: f'{out_prefix}.{k}.json' for k in dets}
    write_results(dets, files)
    return files
