"""High-level API: build / init detectors and batch predict functions.

Port of kgdet_tpu/api.py for the serving path (init_detector, Detector,
make_predict_fn). ``predict(batch)`` returns the same padded dict as the JAX
package's ``eval_loop.make_predict_fns``: det_bboxes (B, M, 5), det_labels
(B, M), det_kpts (B, M, K*3), valid (B, M).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kgdet_tpu.config import KGDetConfig, load_config
from kgdet_tpu_torch.models.detector import KGDetDetector
from kgdet_tpu_torch.models.families import get_head_family
from kgdet_tpu_torch.ops.image import device_normalize


def build_model(cfg: KGDetConfig) -> KGDetDetector:
    if cfg.detector_type != 'single_stage':
        raise NotImplementedError(
            f'detector_type {cfg.detector_type!r} is not ported yet; the '
            'two-stage families are queued in ROADMAP Queue 1 item 6')
    return KGDetDetector(cfg)


def make_predict_fn(model: KGDetDetector, cfg: KGDetConfig, canvas_hw):
    """predict(batch) -> padded detections, on the model's device.

    batch: image (B, H, W, 3) uint8 BGR (normalized on the device) or
    normalized float; img_hw (B, 2) resized extents; scale_factor (B,).
    Tensors or numpy arrays."""
    decode = get_head_family(cfg.head.type).make_decode(cfg, tuple(canvas_hw))

    @torch.inference_mode()
    def predict(batch):
        dev = next(model.parameters()).device
        feed = {k: torch.as_tensor(batch[k]).to(dev)
                for k in ('image', 'img_hw', 'scale_factor')}
        image = device_normalize(feed['image'], feed['img_hw'])
        outs = model(image)
        return decode(outs, feed['img_hw'].float(),
                      feed['scale_factor'].float())
    return predict


class Detector:
    """Single-image inference handle (init_detector / inference_detector).
    Predict functions are kept per canvas bucket."""

    def __init__(self, cfg: KGDetConfig, model: KGDetDetector):
        self.cfg = cfg
        self.model = model
        self._predict_fns = {}

    def _predict_for(self, canvas):
        if canvas not in self._predict_fns:
            self._predict_fns[canvas] = make_predict_fn(
                self.model, self.cfg, canvas)
        return self._predict_fns[canvas]

    def __call__(self, img):
        """img: BGR uint8 (H, W, 3) array or image path. Returns (dets (N, 5)
        xyxy+score, labels (N,), kpts (N, K, 3)) in original image
        coordinates."""
        import cv2

        from kgdet_tpu.data.transforms import (
            imnormalize, imrescale, pad_to_canvas)

        if isinstance(img, str):
            path, img = img, cv2.imread(img)
            if img is None:
                raise FileNotFoundError(path)
        data = self.cfg.val_data
        resized, sf = imrescale(img, data.img_scale)
        rh, rw = resized.shape[:2]
        fitting = [c for c in data.canvas_hw if c[0] >= rh and c[1] >= rw]
        if fitting:
            canvas = min(fitting, key=lambda c: c[0] * c[1])
        else:
            div = data.size_divisor
            canvas = (-(-rh // div) * div, -(-rw // div) * div)
        x = pad_to_canvas(imnormalize(resized).astype(np.float32), canvas)
        dets = self._predict_for(tuple(canvas))({
            'image': x[None],
            'img_hw': np.asarray([[rh, rw]], np.float32),
            'scale_factor': np.asarray([sf], np.float32),
        })
        valid = dets['valid'][0].cpu().numpy()
        boxes = dets['det_bboxes'][0].cpu().numpy()[valid]
        labels = dets['det_labels'][0].cpu().numpy()[valid]
        kpts = dets['det_kpts'][0].cpu().numpy()[valid].reshape(
            -1, self.cfg.head.num_keypts, 3)
        return boxes, labels, kpts


def init_detector(cfg_or_path, pth: Optional[str] = None,
                  jax_variables=None, device='cpu') -> Detector:
    """A ready-to-call Detector: seeded random weights (cfg.seed), or a
    reference .pth, or flax variables of the JAX package's model."""
    cfg = load_config(cfg_or_path) if isinstance(cfg_or_path, str) \
        else cfg_or_path
    model = build_model(cfg).init_weights(cfg.seed)
    if pth is not None:
        from kgdet_tpu.utils.torch_convert import load_pth
        model.load_state_dict(load_pth(pth), strict=True)
    elif jax_variables is not None:
        from kgdet_tpu_torch.utils.convert import state_dict_from_jax
        model.load_state_dict(state_dict_from_jax(jax_variables),
                              strict=True)
    return Detector(cfg, model.to(device).eval())
