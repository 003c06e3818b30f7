"""High-level API: build / init detectors, batch predict functions and
trainers.

Port of kgdet_tpu/api.py (build_model, init_detector, Detector,
make_predict_fn) plus ``init_trainer``. ``predict(batch)`` returns the same
padded dict as the JAX package's ``eval_loop.make_predict_fns``: det_bboxes
(B, M, 5), det_labels (B, M), det_kpts (B, M, K*3), valid (B, M).

Every entry point that places a model takes ``device=None``, which means the
CUDA card and raises where there is none; the CPU is used only when asked
for (``device='cpu'``), as the tests do.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from kgdet_tpu_torch.config import KGDetConfig, load_config
from kgdet_tpu_torch.models.detector import KGDetDetector
from kgdet_tpu_torch.models.families import get_head_family
from kgdet_tpu_torch.ops.image import device_normalize


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card, and an error where there is none: no
    entry point falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'kgdet_tpu_torch runs on a CUDA device and none is available; '
            "pass device='cpu' to run on the CPU")
    return torch.device('cuda')


def build_model(cfg: KGDetConfig, device=None) -> KGDetDetector:
    """The detector of ``cfg`` on ``device`` (None: the CUDA card), with
    the constructors' default weights; ``init_weights`` seeds them."""
    if cfg.detector_type != 'single_stage':
        raise NotImplementedError(
            f'detector_type {cfg.detector_type!r} is not ported yet; the '
            'two-stage families are queued in ROADMAP Queue 1 item 6')
    return KGDetDetector(cfg).to(resolve_device(device))


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

        from kgdet_tpu_torch.data.transforms import (
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


def init_detector(cfg_or_path, checkpoint=None, pth: Optional[str] = None,
                  jax_variables=None, device=None) -> Detector:
    """A ready-to-call Detector on ``device`` (None: the CUDA card): seeded
    random weights (cfg.seed), or a reference .pth, or flax variables of the
    JAX package's model. ``checkpoint`` is second, as in the JAX package,
    and raises until the port has checkpoints of its own."""
    if checkpoint is not None:
        raise NotImplementedError(
            'init_detector(checkpoint=...): the port has no checkpoints of '
            'its own yet (ROADMAP Queue 1 item 3c); a reference .pth loads '
            'with pth=')
    cfg = load_config(cfg_or_path) if isinstance(cfg_or_path, str) \
        else cfg_or_path
    device = resolve_device(device)
    model = build_model(cfg, device='cpu').init_weights(cfg.seed)
    if pth is not None:
        from kgdet_tpu_torch.utils.convert import load_pth
        model.load_state_dict(load_pth(pth), strict=True)
    elif jax_variables is not None:
        from kgdet_tpu_torch.utils.convert import state_dict_from_jax
        model.load_state_dict(state_dict_from_jax(jax_variables),
                              strict=True)
    return Detector(cfg, model.to(device).eval())


def init_trainer(cfg_or_path, canvas_hw, steps_per_epoch: int, device=None):
    """(model, optimizer, train_step) on ``device`` (None: the CUDA card):
    the detector of the config with seeded random weights (cfg.seed), its
    SGD optimizer, and ``train_step(batch) -> logs`` for batches padded to
    ``canvas_hw`` (parallel/train.py::make_train_step)."""
    from kgdet_tpu_torch.parallel.train import make_optimizer, \
        make_train_step
    cfg = load_config(cfg_or_path) if isinstance(cfg_or_path, str) \
        else cfg_or_path
    device = resolve_device(device)
    model = build_model(cfg, device='cpu').init_weights(cfg.seed).to(device)
    optimizer, _ = make_optimizer(cfg, model, steps_per_epoch)
    return model, optimizer, make_train_step(model, cfg, tuple(canvas_hw),
                                             optimizer)
