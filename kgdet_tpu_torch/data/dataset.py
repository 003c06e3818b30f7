"""DeepFashion2 dataset: COCO-json annotations -> fixed-shape training arrays.

TPU-first design: instead of the reference's variable-shape DataContainer
batches (mmdet/datasets/custom.py:200-381 + mmcv collate), every sample is
rendered onto one of a small set of aspect-ratio-bucketed static canvases and
GT arrays are padded to ``max_gts`` with an explicit mask, so the jitted train
step sees only static shapes.

Parity references: the reference's mmdet/datasets/coco.py:64-168
(_filter_imgs/_parse_ann_info conventions: xyxy-inclusive boxes, 1-based
labels, (N, 294, 3) keypoints) and deepfashion2.py:8-99.

The port's own copy of kgdet_tpu/data/dataset.py: NumPy, with images read
and resized through data/image_io.py (no OpenCV needed). Every sample equals
the JAX package's. Precomputed proposals (``DataConfig.proposal_file``,
Fast R-CNN) ride the samples as ``proposals`` / ``proposals_valid``. The
mask families' inputs, ``gt_masks`` (max_gts, H / mask_stride,
W / mask_stride) polygon rasters (``DataConfig.with_mask``) and HTC's
``gt_semantic_seg`` stuff maps at 1 / seg_stride (``DataConfig.seg_prefix``),
fill polygons and resize with OpenCV, as the JAX package does; without cv2
they raise naming it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kgdet_tpu_torch.config import DataConfig
from kgdet_tpu_torch.data import image_io
from kgdet_tpu_torch.data.deepfashion2_meta import (
    CLASSES, KEYPOINT_GROUPS, NUM_KEYPOINTS)
from kgdet_tpu_torch.data.transforms import (
    Expand, PhotoMetricDistortion, RandomCrop, flip_bboxes, flip_keypoints,
    imnormalize, imrescale, keep_ratio_scale, pad_to_canvas, rescale_size)
from kgdet_tpu_torch.eval.coco import CocoIndex

_GROUPS0 = None


def apply_keypoint_groups(kpts: np.ndarray) -> np.ndarray:
    """Propagate each semantic group's visible keypoint to the whole group.

    kpts: (N, 294, 3). For every cross-class group with at least one visible
    keypoint, every slot of the group takes the first visible member's
    (x, y, v). This is the intended semantics of the reference's group_mode
    (custom.py:279-286; the reference's in-place fancy-index assignment only
    executes without error when all group members are already visible, and
    the mode is off in every shipped config).
    """
    global _GROUPS0
    if _GROUPS0 is None:
        _GROUPS0 = [np.asarray(g, np.int64) - 1 for g in KEYPOINT_GROUPS]
    out = kpts.copy()
    for inst in out:
        for group in _GROUPS0:
            vis = inst[group, 2] > 0
            if vis.any():
                inst[group] = inst[group[np.argmax(vis)]]
    return out


@dataclass
class ImageRecord:
    img_id: int
    filename: str
    height: int
    width: int


class DeepFashion2Dataset:
    """Map-style dataset over a COCO-format DeepFashion2 annotation file."""

    # precomputed-proposal store (Fast R-CNN), by img_id
    proposals = None

    def __init__(self, cfg: DataConfig, train: bool = True,
                 min_size: int = 32, min_keypoints: int = 0,
                 filter_empty: Optional[bool] = None):
        self.cfg = cfg
        self.train = train
        self.num_keypoints = NUM_KEYPOINTS
        self.with_keypoints = True
        self.coco = CocoIndex(cfg.ann_file)
        self.cat_ids = self.coco.cat_ids
        self.cat2label = {c: i + 1 for i, c in enumerate(self.cat_ids)}
        if filter_empty is None:
            filter_empty = train
        self.records: List[ImageRecord] = []
        for img_id in self.coco.img_ids:
            info = self.coco.imgs[img_id]
            if train and min(info['width'], info['height']) < min_size:
                continue
            anns = self.coco.anns_for_img(img_id)
            if filter_empty and not any(
                    not a.get('iscrowd', 0) for a in anns):
                continue
            if min_keypoints > 0 and not any(
                    np.count_nonzero(np.asarray(
                        a.get('keypoints', []))[2::3]) >= min_keypoints
                    for a in anns if a.get('keypoints')):
                continue
            self.records.append(ImageRecord(
                img_id, info['file_name'], info['height'], info['width']))
        # aspect-ratio group flag (reference custom.py:174-188)
        self.flags = np.array(
            [1 if r.width / r.height > 1 else 0 for r in self.records],
            dtype=np.int64)
        if cfg.proposal_file:
            self.proposals = self._load_proposals(cfg.proposal_file)

    def _load_proposals(self, path):
        """A .pkl of per-image (P, 4 | 5) proposals (reference custom.py
        proposal_file): a list in the annotation file's image order, or a
        dict keyed by file name or img id. The file is unpickled: load only
        files you trust."""
        import pickle
        with open(path, 'rb') as f:
            raw = pickle.load(f)
        if not isinstance(raw, dict):
            by_id = dict(zip(self.coco.img_ids, raw))
            return {r.img_id: np.asarray(by_id[r.img_id], np.float32)
                    for r in self.records}
        out = {}
        for r in self.records:
            p = raw.get(r.filename, raw.get(r.img_id))
            if p is None:
                raise KeyError(f'proposal_file {path!r} has no entry for '
                               f'{r.filename!r} (img_id {r.img_id})')
            p = np.asarray(p, np.float32)
            out[r.img_id] = p.reshape(-1, p.shape[-1]) if p.size \
                else p.reshape(-1, 4)
        return out

    def _padded_proposals(self, img_id, sf, flip_width=None):
        """(num_proposals, 4) canvas-coordinate proposals and their
        validity: by descending score where the file has one, scaled,
        flipped with the image."""
        P = self.cfg.num_proposals
        out = np.zeros((P, 4), np.float32)
        valid = np.zeros((P,), bool)
        p = self.proposals.get(img_id)
        if p is not None and p.size:
            p = p.reshape(-1, p.shape[-1])
            if p.shape[-1] >= 5:                # score-sorted, scores drop
                p = p[np.argsort(-p[:, 4])]
            p = p[:P, :4] * sf
            if flip_width is not None:
                p = flip_bboxes(p, flip_width)
            out[:len(p)] = p
            valid[:len(p)] = True
        return out, valid

    def _semantic_seg(self, record, sf, flip, canvas):
        """(canvas / seg_stride) int32 stuff-label map of the HTC semantic
        branch from ``seg_prefix``/<image name>.png (or _seg.png), resized
        by the image's scale at nearest neighbour, flipped with it; 255
        pads and marks an image without a map (reference custom.py
        seg_prefix + SegMapTransform)."""
        s = self.cfg.seg_stride
        hs, ws = canvas[0] // s, canvas[1] // s
        out = np.full((hs, ws), 255, np.int32)
        base = os.path.splitext(record.filename)[0]
        for ext in ('.png', '_seg.png'):
            path = os.path.join(self.cfg.seg_prefix, base + ext)
            if os.path.exists(path):
                cv2 = image_io.require_cv2('reading a stuff map')
                seg = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
                if seg is None:
                    break
                nh = max(int(round(seg.shape[0] * sf / s)), 1)
                nw = max(int(round(seg.shape[1] * sf / s)), 1)
                seg = cv2.resize(seg, (nw, nh),
                                 interpolation=cv2.INTER_NEAREST)
                if flip:
                    seg = seg[:, ::-1]
                out[:min(nh, hs), :min(nw, ws)] = \
                    seg[:min(nh, hs), :min(nw, ws)]
                break
        return out

    def __len__(self):
        return len(self.records)

    # ------------------------------------------------------------- parsing
    def parse_annotations(self, img_id: int):
        """GT arrays for one image: boxes xyxy-inclusive, 1-based labels,
        (N, 294, 3) keypoints, plus crowd regions as (Ni, 4) ignore boxes
        (reference coco.py:98-140 gt_bboxes_ignore)."""
        bboxes, labels, kpts, ignore = [], [], [], []
        for ann in self.coco.anns_for_img(img_id):
            x1, y1, w, h = ann['bbox']
            if ann.get('area', w * h) <= 0 or w < 1 or h < 1:
                continue
            if ann.get('iscrowd', 0):
                ignore.append([x1, y1, x1 + w - 1, y1 + h - 1])
                continue
            bboxes.append([x1, y1, x1 + w - 1, y1 + h - 1])
            labels.append(self.cat2label[ann['category_id']])
            kp = np.asarray(ann.get('keypoints', []), dtype=np.float32)
            if kp.size == 0:
                kp = np.zeros((self.num_keypoints, 3), np.float32)
            else:
                kp = kp.reshape(-1, 3)
            if kp.shape[0] != self.num_keypoints:
                fixed = np.zeros((self.num_keypoints, 3), np.float32)
                n_copy = min(kp.shape[0], self.num_keypoints)
                fixed[:n_copy] = kp[:n_copy]
                kp = fixed
            kpts.append(kp)
        ignore_arr = (np.asarray(ignore, np.float32) if ignore
                      else np.zeros((0, 4), np.float32))
        if not bboxes:
            return (np.zeros((0, 4), np.float32), np.zeros((0,), np.int64),
                    np.zeros((0, self.num_keypoints, 3), np.float32),
                    ignore_arr)
        return (np.asarray(bboxes, np.float32),
                np.asarray(labels, np.int64),
                np.stack(kpts).astype(np.float32), ignore_arr)

    def load_image(self, record: ImageRecord) -> np.ndarray:
        return image_io.imread(
            os.path.join(self.cfg.img_prefix, record.filename))

    def flip_kpts(self, kpts, labels, img_w):
        """Horizontal keypoint flip hook; subclasses with other keypoint
        layouts override with their own pair tables."""
        return flip_keypoints(kpts, labels, img_w)

    def canvas_for_flag(self, flag: int) -> Tuple[int, int]:
        """Landscape images (flag 1) -> short-side-height canvas."""
        canvases = self.cfg.canvas_hw
        if len(canvases) == 1:
            return canvases[0]
        return canvases[0] if flag == 1 else canvases[1]

    # ---------------------------------------------------------- extra augs
    _photo_aug = None
    _expand_aug = None
    _crop_aug = None

    def apply_extra_augs(self, img, bboxes, labels, kpts, ignore, rng):
        """Config-driven extra augmentations on the raw BGR image and
        original-scale annotations, in the reference's order
        (custom.py:141-144 + extra_aug.py: photometric -> expand -> crop).
        Ignore boxes ride through the geometric augs (the reference drops
        them here; keeping them is strictly more correct)."""

        if self.cfg.photo_metric_distortion:
            if DeepFashion2Dataset._photo_aug is None:
                DeepFashion2Dataset._photo_aug = PhotoMetricDistortion()
            img = self._photo_aug(img, rng)
        if self.cfg.expand and len(bboxes):
            if DeepFashion2Dataset._expand_aug is None:
                DeepFashion2Dataset._expand_aug = Expand()
            img, bboxes, kpts, ignore = self._expand_aug(
                img, bboxes, kpts, rng, ignore=ignore)
        if self.cfg.random_crop and len(bboxes):
            if DeepFashion2Dataset._crop_aug is None:
                DeepFashion2Dataset._crop_aug = RandomCrop()
            img, bboxes, labels, kpts, ignore = self._crop_aug(
                img, bboxes, labels, kpts, rng, ignore=ignore)
        return img, bboxes, labels, kpts, ignore

    def _finalize_image(self, img: np.ndarray) -> np.ndarray:
        """Either normalize on host (reference semantics) or keep raw uint8
        BGR for device-side normalization (ops/image.device_normalize) —
        the uint8 transfer is 4x smaller on the host->device link."""
        if getattr(self.cfg, 'device_normalize', False):
            if img.dtype != np.uint8:   # float output of photometric augs
                img = np.clip(img, 0, 255).astype(np.uint8)
            return np.ascontiguousarray(img)
        return imnormalize(img)

    # ------------------------------------------------------------ train path
    def prepare_train(self, idx: int, rng: np.random.RandomState) -> Dict:
        record = self.records[idx]
        img = self.load_image(record)
        bboxes, labels, kpts, ignore = self.parse_annotations(record.img_id)

        if (self.cfg.photo_metric_distortion or self.cfg.expand
                or self.cfg.random_crop):
            img, bboxes, labels, kpts, ignore = self.apply_extra_augs(
                img, bboxes, labels, kpts, ignore, rng)

        # geometric augs can flip the aspect class; keep the image inside
        # its flag's canvas bucket (batch grouping needs a static canvas)
        canvas = self.canvas_for_flag(self.flags[idx])
        h0, w0 = img.shape[:2]
        sf = keep_ratio_scale(h0, w0, self.cfg.img_scale)
        sf = min(sf, canvas[0] / h0, canvas[1] / w0)
        nh, nw = rescale_size(h0, w0, sf)
        img = image_io.imresize(img, (nw, nh))
        rh, rw = img.shape[:2]
        img = self._finalize_image(img)
        bboxes = bboxes * sf
        ignore = ignore * sf
        kpts = kpts.copy()
        vis = kpts[..., 2] > 0
        kpts[..., 0] = np.where(vis, kpts[..., 0] * sf, kpts[..., 0])
        kpts[..., 1] = np.where(vis, kpts[..., 1] * sf, kpts[..., 1])

        flipped = self.cfg.flip_ratio > 0 and rng.rand() < self.cfg.flip_ratio
        if flipped:
            img = img[:, ::-1]
            bboxes = flip_bboxes(bboxes, rw)
            if self.with_keypoints:
                kpts = self.flip_kpts(kpts, labels, rw)
            if len(ignore):
                ignore = flip_bboxes(ignore, rw)

        if self.cfg.group_mode:
            kpts = apply_keypoint_groups(kpts)

        img = pad_to_canvas(np.ascontiguousarray(img), canvas)

        G = self.cfg.max_gts
        n = min(len(bboxes), G)
        out_bboxes = np.zeros((G, 4), np.float32)
        out_labels = np.zeros((G,), np.int32)
        out_kpts = np.zeros((G, self.num_keypoints, 3), np.float32)
        out_mask = np.zeros((G,), bool)
        out_bboxes[:n] = bboxes[:n]
        out_labels[:n] = labels[:n]
        out_kpts[:n] = kpts[:n]
        out_mask[:n] = True
        Gi = self.cfg.max_ignore
        ni = min(len(ignore), Gi)
        out_ignore = np.zeros((Gi, 4), np.float32)
        out_ignore_mask = np.zeros((Gi,), bool)
        out_ignore[:ni] = ignore[:ni]
        out_ignore_mask[:ni] = True
        sample = {
            'image': img if img.dtype == np.uint8
            else img.astype(np.float32),
            'valid_hw': np.array([rh, rw], np.int32),
            'gt_bboxes': out_bboxes,
            'gt_labels': out_labels,
            'gt_kpts': out_kpts,
            'gt_mask': out_mask,
            'gt_bboxes_ignore': out_ignore,
            'gt_ignore_mask': out_ignore_mask,
        }
        if self.cfg.with_mask:
            sample['gt_masks'] = self.rasterize_masks(
                record.img_id, sf, rw if flipped else None, canvas)
        if self.proposals is not None:
            sample['proposals'], sample['proposals_valid'] = \
                self._padded_proposals(record.img_id, sf,
                                       rw if flipped else None)
        if self.cfg.seg_prefix:
            sample['gt_semantic_seg'] = self._semantic_seg(
                record, sf, flipped, canvas)
        return sample

    def rasterize_masks(self, img_id, scale_factor, flip_width, canvas):
        """The ground truths' polygons -> (max_gts, canvas_h / s,
        canvas_w / s) float32 rasters, s = mask_stride, in the order of
        parse_annotations (crowd and degenerate boxes skipped), by
        cv2.fillPoly at the downsampled resolution. flip_width: the
        resized image's width when the sample was flipped, else None."""
        cv2 = image_io.require_cv2('rasterizing ground-truth masks')
        s = self.cfg.mask_stride
        mh, mw = canvas[0] // s, canvas[1] // s
        out = np.zeros((self.cfg.max_gts, mh, mw), np.float32)
        gi = 0
        for ann in self.coco.anns_for_img(img_id):
            if ann.get('iscrowd', 0):
                continue
            x1, y1, w, h = ann['bbox']
            if ann.get('area', w * h) <= 0 or w < 1 or h < 1:
                continue
            if gi >= self.cfg.max_gts:
                break
            canvas_mask = np.zeros((mh, mw), np.uint8)
            for poly in ann.get('segmentation') or []:
                pts = np.asarray(poly, np.float64).reshape(-1, 2)
                pts = pts * scale_factor
                if flip_width is not None:
                    pts[:, 0] = flip_width - pts[:, 0] - 1
                cv2.fillPoly(canvas_mask,
                             [np.round(pts / s).astype(np.int32)], 1)
            out[gi] = canvas_mask
            gi += 1
        return out

    # ------------------------------------------------------------- test path
    def prepare_test(self, idx: int, flip: bool = False,
                     img_scale=None) -> Dict:
        """Test sample; flip/img_scale serve multi-scale/flip TTA variants
        (reference custom.py prepare_test_img:316-381)."""
        record = self.records[idx]
        img = self.load_image(record)
        img, sf = imrescale(img, img_scale or self.cfg.img_scale)
        rh, rw = img.shape[:2]
        img = self._finalize_image(img)
        if flip:
            img = img[:, ::-1]
        canvas = self.canvas_for_flag(self.flags[idx])
        if canvas[0] < rh or canvas[1] < rw:
            # TTA scales beyond the configured buckets: fall back to the
            # smallest fitting canvas (Detector.__call__ order), then to a
            # /size_divisor-rounded bucket
            fitting = [c for c in self.cfg.canvas_hw
                       if c[0] >= rh and c[1] >= rw]
            if fitting:
                canvas = min(fitting, key=lambda c: c[0] * c[1])
            else:
                # derive the canvas from the requested scale + aspect flag
                # (not per-image rh/rw) so every image in an aspect group
                # shares one shape — batch>1 collation and the lazily built
                # predict fn then see a single canvas per (scale, flag)
                div = self.cfg.size_divisor
                scale = tuple(img_scale or self.cfg.img_scale)
                long_s, short_s = max(scale), min(scale)
                hh, ww = ((short_s, long_s) if self.flags[idx] == 1
                          else (long_s, short_s))
                canvas = (max(-(-hh // div), -(-rh // div)) * div,
                          max(-(-ww // div), -(-rw // div)) * div)
        img = pad_to_canvas(np.ascontiguousarray(img), canvas)
        out = {
            'image': img if img.dtype == np.uint8
            else img.astype(np.float32),
            'img_hw': np.array([rh, rw], np.float32),
            'scale_factor': np.float32(sf),
            'flipped': np.bool_(flip),
            'img_id': record.img_id,
        }
        if self.proposals is not None:
            out['proposals'], out['proposals_valid'] = \
                self._padded_proposals(record.img_id, sf,
                                       rw if flip else None)
        return out

    @property
    def class_names(self):
        return CLASSES
