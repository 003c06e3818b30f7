"""Host-side image/annotation transforms (NumPy), the port's own copy of
kgdet_tpu/data/transforms.py.

Keep-ratio rescale -> RGB normalize -> random horizontal flip (with per-class
keypoint pair remapping) -> pad to a fixed canvas, and the extra training
augmentations (photometric distortion, expand, min-IoU crop), each drawing
from the caller's ``np.random.RandomState`` in the same order as the JAX
package. Images are resized through ``data/image_io.py``, which needs no
OpenCV; only ``PhotoMetricDistortion`` (its HSV round trip) does.

Parity references: the reference's mmdet/datasets/transforms.py
(ImageTransform:11-70, BboxTransform:72-95, KeypointTransform:147-180,
fliplr_joints:134-145) and mmdet/datasets/extra_aug.py (PhotoMetricDistortion,
Expand, RandomCrop).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from kgdet_tpu_torch.data import image_io
from kgdet_tpu_torch.data.deepfashion2_meta import (
    IMG_MEAN, IMG_STD, class_flip_pairs)


def keep_ratio_scale(h: int, w: int, img_scale: Tuple[int, int]) -> float:
    """mmcv.imrescale scale factor: fit (h, w) inside (long, short)."""
    long_side, short_side = max(img_scale), min(img_scale)
    return min(long_side / max(h, w), short_side / min(h, w))


def rescale_size(h: int, w: int, scale: float) -> Tuple[int, int]:
    """mmcv rounding convention: int(dim * scale + 0.5)."""
    return int(h * scale + 0.5), int(w * scale + 0.5)


def imrescale(img: np.ndarray, img_scale: Tuple[int, int]):
    """Keep-ratio bilinear resize. Returns (resized, scale_factor)."""
    h, w = img.shape[:2]
    sf = keep_ratio_scale(h, w, img_scale)
    nh, nw = rescale_size(h, w, sf)
    resized = image_io.imresize(img, (nw, nh))
    return resized, sf


def imnormalize(img: np.ndarray, mean=IMG_MEAN, std=IMG_STD,
                to_rgb: bool = True) -> np.ndarray:
    """(img - mean) / std in float32; BGR->RGB first when to_rgb."""
    img = img.astype(np.float32)
    if to_rgb:
        img = img[..., ::-1]
    return (img - mean) / std


def pad_to_canvas(img: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to the canvas shape."""
    h, w = img.shape[:2]
    ch, cw = canvas_hw
    if h > ch or w > cw:
        raise ValueError(f'image {img.shape} exceeds canvas {canvas_hw}')
    out = np.zeros((ch, cw) + img.shape[2:], dtype=img.dtype)
    out[:h, :w] = img
    return out


def pad_to_divisor(img: np.ndarray, divisor: int = 32) -> np.ndarray:
    h, w = img.shape[:2]
    ch = (h + divisor - 1) // divisor * divisor
    cw = (w + divisor - 1) // divisor * divisor
    return pad_to_canvas(img, (ch, cw))


def flip_bboxes(bboxes: np.ndarray, img_w: int) -> np.ndarray:
    """Horizontal flip for xyxy boxes (legacy -1 convention)."""
    out = bboxes.copy()
    out[..., 0] = img_w - bboxes[..., 2] - 1
    out[..., 2] = img_w - bboxes[..., 0] - 1
    return out


_FLIP_PAIRS = None


def flip_keypoints(kpts: np.ndarray, labels: np.ndarray,
                   img_w: int) -> np.ndarray:
    """Horizontal flip for (N, 294, 3) keypoints with per-class pair swaps.

    Mirrors fliplr_joints: x' = w - x - 1 for visible points, then swap each
    class's left/right pairs (only within the instance's own class slice).
    """
    global _FLIP_PAIRS
    if _FLIP_PAIRS is None:
        _FLIP_PAIRS = class_flip_pairs()
    out = kpts.copy()
    vis = out[..., 2] > 0
    out[..., 0] = np.where(vis, img_w - out[..., 0] - 1, out[..., 0])
    for i in range(out.shape[0]):
        pairs = _FLIP_PAIRS[int(labels[i]) - 1]
        for a, b in pairs:
            out[i, [a, b]] = out[i, [b, a]]
    return out


class PhotoMetricDistortion:
    """Random brightness/contrast/saturation/hue jitter (BGR uint8 input).

    Off by default in the KGDet recipe; provided for parity with
    extra_aug.py:8-66.
    """

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, img, rng: np.random.RandomState):
        cv2 = image_io.cv2
        if cv2 is None:     # its HSV round trip has no own code in the port
            raise ImportError('PhotoMetricDistortion needs OpenCV (cv2), '
                              'which is not installed')
        img = img.astype(np.float32)
        if rng.randint(2):
            img += rng.uniform(-self.brightness_delta, self.brightness_delta)
        contrast_first = rng.randint(2)
        if contrast_first and rng.randint(2):
            img *= rng.uniform(self.contrast_lower, self.contrast_upper)
        hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                           cv2.COLOR_BGR2HSV).astype(np.float32)
        if rng.randint(2):
            hsv[..., 1] *= rng.uniform(self.saturation_lower,
                                       self.saturation_upper)
        if rng.randint(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(
                -self.hue_delta, self.hue_delta)) % 180
        img = cv2.cvtColor(
            np.clip(hsv, 0, 255).astype(np.uint8),
            cv2.COLOR_HSV2BGR).astype(np.float32)
        if not contrast_first and rng.randint(2):
            img *= rng.uniform(self.contrast_lower, self.contrast_upper)
        return np.clip(img, 0, 255).astype(np.uint8)


class Expand:
    """Place the image on a larger mean-filled canvas (extra_aug.py:67-91)."""

    def __init__(self, mean=(0, 0, 0), to_rgb=True, ratio_range=(1, 4)):
        self.mean = mean if not to_rgb else mean[::-1]
        self.min_ratio, self.max_ratio = ratio_range

    def __call__(self, img, boxes, kpts, rng: np.random.RandomState,
                 ignore=None):
        if rng.randint(2):
            return (img, boxes, kpts) if ignore is None else \
                (img, boxes, kpts, ignore)
        h, w, c = img.shape
        ratio = rng.uniform(self.min_ratio, self.max_ratio)
        canvas = np.empty((int(h * ratio), int(w * ratio), c), img.dtype)
        canvas[...] = self.mean
        left = int(rng.uniform(0, w * ratio - w))
        top = int(rng.uniform(0, h * ratio - h))
        canvas[top:top + h, left:left + w] = img
        boxes = boxes + np.tile((left, top), 2)
        if kpts is not None:
            kpts = kpts.copy()
            vis = kpts[..., 2] > 0
            kpts[..., 0] = np.where(vis, kpts[..., 0] + left, kpts[..., 0])
            kpts[..., 1] = np.where(vis, kpts[..., 1] + top, kpts[..., 1])
        if ignore is None:
            return canvas, boxes, kpts
        ignore = ignore + np.tile((left, top), 2) if len(ignore) else ignore
        return canvas, boxes, kpts, ignore


class RandomCrop:
    """Min-IoU random crop keeping box centers (extra_aug.py:92-146)."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size=0.3):
        self.sample_mode = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size

    def __call__(self, img, boxes, labels, kpts, rng: np.random.RandomState,
                 ignore=None):
        h, w, _ = img.shape
        while True:
            mode = self.sample_mode[rng.randint(len(self.sample_mode))]
            if mode == 1:
                return (img, boxes, labels, kpts) if ignore is None else \
                    (img, boxes, labels, kpts, ignore)
            min_iou = mode
            for _ in range(50):
                new_w = rng.uniform(self.min_crop_size * w, w)
                new_h = rng.uniform(self.min_crop_size * h, h)
                if new_h / new_w < 0.5 or new_h / new_w > 2:
                    continue
                left = rng.uniform(w - new_w)
                top = rng.uniform(h - new_h)
                patch = np.array(
                    [int(left), int(top), int(left + new_w), int(top + new_h)])
                iou = _iou_xyxy(boxes, patch[None])
                if iou.min() < min_iou:
                    continue
                ctr = (boxes[:, :2] + boxes[:, 2:]) / 2
                mask = ((ctr[:, 0] > patch[0]) & (ctr[:, 1] > patch[1]) &
                        (ctr[:, 0] < patch[2]) & (ctr[:, 1] < patch[3]))
                if not mask.any():
                    continue
                img = img[patch[1]:patch[3], patch[0]:patch[2]]
                boxes = boxes[mask].copy()
                labels = labels[mask]
                boxes[:, 2:] = boxes[:, 2:].clip(max=patch[2:])
                boxes[:, :2] = boxes[:, :2].clip(min=patch[:2])
                boxes -= np.tile(patch[:2], 2)
                if kpts is not None:
                    kpts = kpts[mask].copy()
                    kpts[..., 0] -= patch[0]
                    kpts[..., 1] -= patch[1]
                    inside = ((kpts[..., 0] >= 0) &
                              (kpts[..., 0] < patch[2] - patch[0]) &
                              (kpts[..., 1] >= 0) &
                              (kpts[..., 1] < patch[3] - patch[1]))
                    kpts[..., 2] = np.where(inside, kpts[..., 2], 0)
                if ignore is None:
                    return img, boxes, labels, kpts
                if len(ignore):
                    ignore = ignore.copy()
                    ignore[:, 2:] = ignore[:, 2:].clip(max=patch[2:])
                    ignore[:, :2] = ignore[:, :2].clip(min=patch[:2])
                    ignore -= np.tile(patch[:2], 2)
                    keep = ((ignore[:, 2] > ignore[:, 0]) &
                            (ignore[:, 3] > ignore[:, 1]))
                    ignore = ignore[keep]
                return img, boxes, labels, kpts, ignore


def _iou_xyxy(a, b):
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(b[:, 2:] - b[:, :2], axis=1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-10)
