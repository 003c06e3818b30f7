"""High-level API: build / init detectors, batch predict functions and
trainers.

Port of kgdet_tpu/api.py (build_model, init_detector, Detector with its
multi-scale / flip ``aug_call``, inference_detector, make_predict_fn) plus
``make_raw_predict_fn`` (the pre-NMS decode of test-time augmentation) and
``init_trainer``. ``predict(batch)`` returns the same
padded dict as the JAX package's ``eval_loop.make_predict_fns``: det_bboxes
(B, M, 5), det_labels (B, M), det_kpts (B, M, K*3), valid (B, M); the mask
families add det_masks (B, M, S, S) and Mask Scoring R-CNN
det_mask_scores (B, M).

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
from kgdet_tpu_torch.models.families import get_head_family, \
    is_two_stage, two_stage_decoder
from kgdet_tpu_torch.ops.image import device_normalize
from kgdet_tpu_torch.utils.trace import span


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


def build_model(cfg: KGDetConfig, device=None):
    """The detector of ``cfg`` on ``device`` (None: the CUDA card), with
    the constructors' default weights; ``init_weights`` seeds them: a
    single-stage KGDetDetector, or by ``cfg.detector_type`` a two-stage
    RPNDetector, FasterRCNN (Fast R-CNN with external proposals; Mask R-CNN
    and Mask Scoring R-CNN with mask heads, Grid R-CNN with the grid head,
    GA-RPN with cfg.rpn_type 'ga_rpn') or CascadeRCNN (HTC with its mask
    stages and semantic branch) (models/two_stage.py)."""
    if is_two_stage(cfg.detector_type):
        from kgdet_tpu_torch.models.two_stage import build_two_stage
        model = build_two_stage(cfg)
    else:
        model = KGDetDetector(cfg)
    return model.to(resolve_device(device))


# Fast R-CNN's precomputed proposals, which ride the batch
PROPOSAL_KEYS = ('proposals', 'proposals_valid')


def make_predict_fn(model, cfg: KGDetConfig, canvas_hw):
    """predict(batch) -> padded detections, on the model's device.

    batch: image (B, H, W, 3) uint8 BGR (normalized on the device) or
    normalized float; img_hw (B, 2) resized extents; scale_factor (B,);
    for Fast R-CNN proposals (B, R, 4) and proposals_valid (B, R). Tensors
    or numpy arrays."""
    if is_two_stage(cfg.detector_type):
        decode2 = two_stage_decoder(cfg.detector_type)

        @torch.inference_mode()
        def predict(batch):
            with span('predict'):
                feed = _feed(model, batch, PROPOSAL_KEYS)
                img_hw = feed['img_hw'].float()
                with span('forward'):
                    fwd = model(
                        device_normalize(feed['image'], feed['img_hw']),
                        img_hw, train=False,
                        **{k: feed[k] for k in PROPOSAL_KEYS if k in feed})
                with span('decode'):
                    return decode2(fwd, img_hw, feed['scale_factor'].float(),
                                   cfg.test, cfg.head.num_classes)
        return predict
    decode = get_head_family(cfg.head.type).make_decode(cfg, tuple(canvas_hw))

    @torch.inference_mode()
    def predict(batch):
        with span('predict'):
            feed, outs = _forward(model, batch)
            with span('decode'):
                return decode(outs, feed['img_hw'].float(),
                              feed['scale_factor'].float())
    return predict


def _feed(model, batch, optional=()):
    """The batch's tensors on the model's device: image, img_hw,
    scale_factor and those of ``optional`` that it has."""
    dev = next(model.parameters()).device
    keys = ('image', 'img_hw', 'scale_factor') + tuple(
        k for k in optional if k in batch)
    return {k: torch.as_tensor(batch[k]).to(dev) for k in keys}


def _forward(model, batch):
    """The batch's tensors on the model's device and the head outputs."""
    feed = _feed(model, batch)
    with span('forward'):
        return feed, model(device_normalize(feed['image'], feed['img_hw']))


def make_raw_predict_fn(model: KGDetDetector, cfg: KGDetConfig, canvas_hw):
    """predict(batch) -> (bboxes (B, N, 4), scores (B, N, C), kpts
    (B, N, K*3)): the decode before NMS, in original-image coordinates,
    which test-time augmentation merges over its variants before one NMS
    (core/postprocess.py::decode_raw)."""
    from kgdet_tpu_torch.core.postprocess import decode_raw
    from kgdet_tpu_torch.models.families import BOX_FAMILIES, level_grids
    if is_two_stage(cfg.detector_type):
        raise NotImplementedError(
            'test-time augmentation decodes the single-stage point families '
            f'only; {cfg.detector_type} has no pre-NMS decode')
    if cfg.head.type in BOX_FAMILIES:
        raise NotImplementedError(
            f'test-time augmentation decodes the point families only, as '
            f'in the JAX package; {cfg.head.type} predicts no keypoints')
    grids = {}                      # the static level grids, once a device

    @torch.inference_mode()
    def predict(batch):
        feed, outs = _forward(model, batch)
        dev = feed['img_hw'].device
        if dev not in grids:
            grids[dev] = level_grids(cfg, tuple(canvas_hw), device=dev)
        return decode_raw(outs, grids[dev], feed['img_hw'].float(),
                          feed['scale_factor'].float(), cfg.test,
                          num_keypts=cfg.head.num_keypts)
    return predict


def _canvas_for(data, rh: int, rw: int):
    """The smallest configured canvas that holds a resized (rh, rw) image
    (least padded area); a /size_divisor-rounded one where none does."""
    fitting = [c for c in data.canvas_hw if c[0] >= rh and c[1] >= rw]
    if fitting:
        return tuple(min(fitting, key=lambda c: c[0] * c[1]))
    div = data.size_divisor
    return (-(-rh // div) * div, -(-rw // div) * div)


def _read(img):
    from kgdet_tpu_torch.data.image_io import imread
    return imread(img) if isinstance(img, str) else img


class Detector:
    """Single-image inference handle (init_detector / inference_detector).
    Predict functions are kept per canvas bucket."""

    def __init__(self, cfg: KGDetConfig, model: KGDetDetector):
        self.cfg = cfg
        self.model = model
        self._predict_fns = {}
        self._raw_predict_fns = {}

    def _predict_for(self, canvas):
        if canvas not in self._predict_fns:
            self._predict_fns[canvas] = make_predict_fn(
                self.model, self.cfg, canvas)
        return self._predict_fns[canvas]

    def __call__(self, img):
        """img: BGR uint8 (H, W, 3) array or image path. Returns (dets (N, 5)
        xyxy+score, labels (N,), kpts (N, K, 3)) in original image
        coordinates; K is 1, a zero keypoint, for the box families
        (RetinaNet, SSD, FCOS, GA-Retina) and the two-stage detectors. The
        mask families add masks (N, H, W) uint8, each detection's mask
        pasted into the image, and Mask Scoring R-CNN its mask scores
        (N,)."""
        from kgdet_tpu_torch.data.transforms import (
            imnormalize, imrescale, pad_to_canvas)

        with span('request'):
            img = _read(img)
            data = self.cfg.val_data
            with span('preprocess'):
                resized, sf = imrescale(img, data.img_scale)
                rh, rw = resized.shape[:2]
                canvas = _canvas_for(data, rh, rw)
                x = pad_to_canvas(imnormalize(resized).astype(np.float32),
                                  canvas)
            dets = self._predict_for(canvas)({
                'image': x[None],
                'img_hw': np.asarray([[rh, rw]], np.float32),
                'scale_factor': np.asarray([sf], np.float32),
            })
            with span('fetch'):
                valid = dets['valid'][0].cpu().numpy()

                def host(k):
                    return dets[k][0].cpu().numpy()[valid]
                boxes, labels, kpts = (host(k) for k in (
                    'det_bboxes', 'det_labels', 'det_kpts'))
            # (N, K, 3); the box families carry one dummy keypoint a box
            out = (boxes, labels, kpts.reshape(len(kpts), -1, 3))
            if 'det_masks' not in dets:
                return out
            from kgdet_tpu_torch.models.mask_head import paste_masks
            h, w = img.shape[:2]
            masks = np.stack(paste_masks(boxes, host('det_masks'), h, w)) \
                if len(boxes) else np.zeros((0, h, w), np.uint8)
            out += (masks,)
            if 'det_mask_scores' in dets:
                out += (host('det_mask_scores'),)
            return out

    def _raw_predict_for(self, canvas):
        """The pre-NMS decode for one canvas (the TTA merge path)."""
        if canvas not in self._raw_predict_fns:
            self._raw_predict_fns[canvas] = make_raw_predict_fn(
                self.model, self.cfg, canvas)
        return self._raw_predict_fns[canvas]

    def aug_call(self, img, scales=None, flip=True, score_thr=None):
        """Multi-scale / flip test-time augmentation (boxes only).

        Reference merge order (reppoints_detector_kp.py:93-148): the raw
        pre-NMS boxes of every variant, mapped back to original
        coordinates, are concatenated and suppressed by ONE multiclass NMS;
        keypoints are dropped in aug mode. Returns (dets (N, 5), labels
        (N,))."""
        from kgdet_tpu_torch.data.transforms import (
            imnormalize, imrescale, pad_to_canvas)
        from kgdet_tpu_torch.ops.nms import multiclass_nms_kp

        img = _read(img)
        data = self.cfg.val_data
        scales = [tuple(s) for s in (scales or [data.img_scale])]
        all_boxes, all_scores = [], []
        for scale in scales:
            for do_flip in ([False, True] if flip else [False]):
                resized, sf = imrescale(img, scale)
                rh, rw = resized.shape[:2]
                if do_flip:
                    resized = resized[:, ::-1]
                canvas = _canvas_for(data, rh, rw)
                x = pad_to_canvas(
                    imnormalize(np.ascontiguousarray(resized)).astype(
                        np.float32), canvas)
                bboxes, sc, _ = self._raw_predict_for(canvas)({
                    'image': x[None],
                    'img_hw': np.asarray([[rh, rw]], np.float32),
                    'scale_factor': np.asarray([sf], np.float32),
                })
                b = bboxes[0].cpu().numpy()
                if do_flip:
                    lim = (rw - 1) / sf
                    b = b.copy()
                    b[:, [0, 2]] = lim - b[:, [2, 0]]
                all_boxes.append(b)
                all_scores.append(sc[0].cpu().numpy())
        dev = next(self.model.parameters()).device
        boxes = torch.from_numpy(np.concatenate(all_boxes)).to(dev)
        scores = torch.from_numpy(np.concatenate(all_scores)).to(dev)
        t = self.cfg.test
        det_b, det_l, _, valid = multiclass_nms_kp(
            boxes, scores, boxes.new_zeros((len(boxes), 3)),
            score_thr if score_thr is not None else t.score_thr,
            t.nms_iou_thr, max_per_class=t.max_per_class,
            max_per_img=t.max_per_img)
        v = valid.cpu().numpy()
        return det_b.cpu().numpy()[v], det_l.cpu().numpy()[v]


def init_detector(cfg_or_path, checkpoint=None, pth: Optional[str] = None,
                  jax_variables=None, device=None) -> Detector:
    """A ready-to-call Detector on ``device`` (None: the CUDA card): seeded
    random weights (cfg.seed), or, in this order of precedence, a reference
    .pth (utils/convert.py::load_reference_state: keys the JAX package's
    converter skips are dropped, model keys the .pth lacks keep their
    seeded values), a checkpoint of the port (``checkpoint``, second as in
    the JAX package: a train-state step such as ``work_dir/checkpoints/16``
    or a params-only save, utils/checkpoint.py::load_params), or flax
    variables of the JAX package's model."""
    cfg = load_config(cfg_or_path) if isinstance(cfg_or_path, str) \
        else cfg_or_path
    device = resolve_device(device)
    model = build_model(cfg, device='cpu').init_weights(cfg.seed)
    if pth is not None:
        from kgdet_tpu_torch.utils.convert import (load_pth,
                                                   load_reference_state)
        load_reference_state(model, load_pth(pth))
    elif checkpoint is not None:
        from kgdet_tpu_torch.utils.checkpoint import load_params
        model.load_state_dict(load_params(checkpoint), strict=True)
    elif jax_variables is not None:
        from kgdet_tpu_torch.utils.convert import state_dict_from_jax
        model.load_state_dict(state_dict_from_jax(jax_variables),
                              strict=True)
    return Detector(cfg, model.to(device).eval())


def inference_detector(detector: Detector, img):
    """Functional alias matching the reference API name."""
    return detector(img)


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
