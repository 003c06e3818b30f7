"""Head-family records: build + loss + decode per single-stage head family.

Port of kgdet_tpu/models/families.py: the records of the point-based
families, ``KGDetHead`` and its single-column ablation ``KGDetHead1Rep``,
and the init/refine heads ``SerialKpHead``, ``ParallelKpHead`` and
``RepPointsHead``; of the anchor-based ``RetinaHead`` and ``SSDHead``,
whose anchors are static per canvas and made once a device; of the
anchor-free ``FCOSHead`` (on the level grids) and of ``GARetinaHead``
(guided anchors). ``get_head_family`` raises ``KeyError`` for any other
name, as the JAX registry does. The two-stage detectors dispatch on
``cfg.detector_type`` instead (``two_stage_decoder``, ``is_two_stage``),
each decoding through core/two_stage_loss.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

from kgdet_tpu_torch.ops.points import grid_points


@dataclass(frozen=True)
class HeadFamily:
    """build(cfg) -> head module; loss(outs, grids, valids, batch, cfg,
    canvas_hw) -> (total, logs); make_decode(cfg, canvas) ->
    decode(outs, img_hw, scale_factor) -> padded detections."""
    build: Callable
    loss: Callable
    make_decode: Callable


def level_grids(cfg, canvas_hw, device=None):
    """Static per-level (H*W, 3) grids for a padded canvas."""
    H, W = canvas_hw
    return [grid_points(-(-H // s), -(-W // s), s, device=device)
            for s in cfg.head.point_strides]


def _build_kgdet(cfg):
    from kgdet_tpu_torch.models.kgdet_head import KGDetHead
    return KGDetHead.from_config(cfg)


def _build_kgdet_1rep(cfg):
    from kgdet_tpu_torch.models.kgdet_head import KGDetHead
    return KGDetHead.from_config(cfg, column_taps=(cfg.head.num_reppts,))


def _point_init_targets(grids, valids, batch, cfg):
    from kgdet_tpu_torch.core.targets import point_targets
    return [point_targets(g, v, batch['gt_bboxes'], batch['gt_labels'],
                          batch['gt_kpts'], batch['gt_mask'],
                          scale=cfg.assigner.scale,
                          pos_num=cfg.assigner.pos_num)
            for g, v in zip(grids, valids)]


def _kgdet_loss(outs, grids, valids, batch, cfg, canvas_hw):
    from kgdet_tpu_torch.core.loss import kgdet_loss
    return kgdet_loss(outs, grids,
                      _point_init_targets(grids, valids, batch, cfg),
                      cfg.head)


def _make_point_decode(cfg, canvas):
    from kgdet_tpu_torch.core.postprocess import decode_detections
    grids = {}                      # the static level grids, once a device

    def decode(outs, img_hw, scale_factor):
        dev = img_hw.device
        if dev not in grids:
            grids[dev] = level_grids(cfg, canvas, device=dev)
        return decode_detections(outs, grids[dev], img_hw, scale_factor,
                                 cfg.test, num_keypts=cfg.head.num_keypts)
    return decode


def _build_serial(parallel=False, with_keypoints=True):
    def build(cfg):
        from kgdet_tpu_torch.models.serial_head import SerialKpHead
        return SerialKpHead.from_config(cfg, parallel=parallel,
                                        with_keypoints=with_keypoints)
    return build


def _serial_loss(outs, grids, valids, batch, cfg, canvas_hw):
    """Init stage on the point targets; refine stage on MaxIoU targets over
    the candidate boxes that the detached init stage decodes to."""
    from kgdet_tpu_torch.core.loss import serial_loss
    from kgdet_tpu_torch.core.targets import max_iou_targets
    ra = cfg.refine_assigner
    if ra is None:
        raise ValueError(f'{cfg.head.type} requires cfg.refine_assigner')
    init_targets = _point_init_targets(grids, valids, batch, cfg)
    refine_targets = []
    for o, g, v in zip(outs, grids, valids):
        stride = g[0, 2]
        centers = torch.cat([g[:, :2], g[:, :2]], dim=-1)
        bbox_off = o['bbox'][0].detach().float()
        cand = bbox_off.reshape(bbox_off.shape[0], -1, 4) * stride \
            + centers[None]
        refine_targets.append(max_iou_targets(
            cand, v, batch['gt_bboxes'], batch['gt_labels'],
            batch['gt_kpts'], batch['gt_mask'],
            pos_iou_thr=ra.pos_iou_thr, neg_iou_thr=ra.neg_iou_thr,
            min_pos_iou=ra.min_pos_iou,
            gt_bboxes_ignore=batch.get('gt_bboxes_ignore'),
            gt_ignore_mask=batch.get('gt_ignore_mask'),
            ignore_iof_thr=ra.ignore_iof_thr))
    return serial_loss(outs, grids, init_targets, refine_targets, cfg.head)


def _point_family(build, loss):
    return HeadFamily(build=build, loss=loss, make_decode=_make_point_decode)


# ------------------------------------------------------ anchor-based heads
def _base_anchors(head):
    """The head config's per-level base anchors (NumPy) and anchor
    counts."""
    if head.type == 'SSDHead':
        from kgdet_tpu_torch.models.ssd_head import ssd_base_anchor_set
        bases = ssd_base_anchor_set(head.ssd_input_size, head.point_strides,
                                    head.ssd_basesize_ratio_range,
                                    head.ssd_anchor_ratios)
    else:
        from kgdet_tpu_torch.models.retina_head import retina_base_anchors
        bases = retina_base_anchors(head.octave_base_scale,
                                    head.scales_per_octave,
                                    head.anchor_ratios, head.point_strides)
    return bases, [len(b) for b in bases]


def _grid_anchor_set(head, canvas, device):
    """Per level the (H*W*A, 4) anchors of a padded canvas, on
    ``device``."""
    from kgdet_tpu_torch.ops.anchors import grid_anchors
    H, W = canvas
    return [grid_anchors(b, -(-H // s), -(-W // s), s, device=device)
            for b, s in zip(_base_anchors(head)[0], head.point_strides)]


def _anchor_valid_set(head, canvas, valid_hw):
    """(B, P_l) per-level anchor validity from padded extents (pixels)."""
    from kgdet_tpu_torch.ops.anchors import anchor_valid_flags
    H, W = canvas
    outs = []
    for stride, A in zip(head.point_strides, _base_anchors(head)[1]):
        vh = torch.ceil(valid_hw[:, 0] / stride).to(torch.int32)
        vw = torch.ceil(valid_hw[:, 1] / stride).to(torch.int32)
        outs.append(anchor_valid_flags(-(-H // stride), -(-W // stride), A,
                                       vh, vw))
    return outs


IDENTITY_NECKS = (None, 'none', 'Identity')


def head_in_channels(cfg):
    """The channels of each level the head reads: the neck's width, or
    with the ``Identity`` neck the backbone's levels."""
    n = len(cfg.head.point_strides)
    if cfg.neck.type not in IDENTITY_NECKS:
        return (cfg.neck.out_channels,) * n
    if cfg.backbone.type == 'SSDVGG':
        from kgdet_tpu_torch.models.vgg import vgg_out_channels
        return vgg_out_channels(cfg.backbone.vgg_input_size)
    from kgdet_tpu_torch.models.resnet import ResNet
    chans = ResNet.stage_channels(cfg.backbone.depth)
    return tuple(chans[i] for i in cfg.backbone.out_indices)


def _anchor_loss(loss):
    def family_loss(outs, grids, valids, batch, cfg, canvas_hw):
        canvas = tuple(canvas_hw)
        # made each step: a few small tensor ops a level beside the step
        anchors = _grid_anchor_set(cfg.head, canvas,
                                   batch['valid_hw'].device)
        avalids = _anchor_valid_set(cfg.head, canvas, batch['valid_hw'])
        return loss(outs, anchors, avalids, batch, cfg,
                    cfg.refine_assigner or cfg.assigner)
    return family_loss


def _retina_loss(outs, anchors, avalids, batch, cfg, assign_cfg):
    from kgdet_tpu_torch.core.anchor_loss import retina_loss
    return retina_loss(outs, anchors, avalids, batch, cfg.head, assign_cfg)


def _ssd_loss(outs, anchors, avalids, batch, cfg, assign_cfg):
    from kgdet_tpu_torch.core.anchor_loss import ssd_loss
    return ssd_loss(outs, anchors, avalids, batch, cfg.head, assign_cfg,
                    neg_pos_ratio=cfg.head.ssd_neg_pos_ratio,
                    target_stds=cfg.head.target_stds)


def _make_anchor_decode(cfg, canvas):
    from kgdet_tpu_torch.core.anchor_loss import (decode_detections_anchor,
                                                  decode_detections_ssd)
    canvas = tuple(canvas)
    anchor_sets = {}                # the static anchors, once a device

    def decode(outs, img_hw, scale_factor):
        dev = img_hw.device
        if dev not in anchor_sets:
            anchor_sets[dev] = _grid_anchor_set(cfg.head, canvas, dev)
        anchors = anchor_sets[dev]
        if cfg.head.type == 'SSDHead':
            return decode_detections_ssd(
                outs, anchors, img_hw, scale_factor, cfg.test,
                num_classes=cfg.head.num_classes,
                target_stds=cfg.head.target_stds)
        return decode_detections_anchor(
            outs, anchors, img_hw, scale_factor, cfg.test,
            num_classes=cfg.head.num_classes)
    return decode


def _build_retina(cfg):
    from kgdet_tpu_torch.models.retina_head import RetinaHead
    return RetinaHead.from_config(cfg)


def _build_ssd(cfg):
    from kgdet_tpu_torch.models.ssd_head import SSDHead
    return SSDHead.from_config(cfg, head_in_channels(cfg))


# ------------------------------------------------------------------- FCOS
def _build_fcos(cfg):
    from kgdet_tpu_torch.models.fcos_head import FCOSHead
    return FCOSHead.from_config(cfg)


def _fcos_loss(outs, grids, valids, batch, cfg, canvas_hw):
    from kgdet_tpu_torch.core.fcos_loss import fcos_loss
    return fcos_loss(outs, grids, valids, batch, cfg.head)


def _make_fcos_decode(cfg, canvas):
    from kgdet_tpu_torch.core.fcos_loss import decode_detections_fcos
    grids = {}                      # the static level grids, once a device

    def decode(outs, img_hw, scale_factor):
        dev = img_hw.device
        if dev not in grids:
            grids[dev] = level_grids(cfg, canvas, device=dev)
        return decode_detections_fcos(outs, grids[dev], img_hw,
                                      scale_factor, cfg.test,
                                      num_classes=cfg.head.num_classes)
    return decode


# -------------------------------------------------------------- GA-Retina
def _build_ga_retina(cfg):
    from kgdet_tpu_torch.models.ga_head import GARetinaHead
    return GARetinaHead.from_config(cfg)


def _ga_retina_loss(outs, grids, valids, batch, cfg, canvas_hw):
    from kgdet_tpu_torch.core.ga_loss import ga_loss
    return ga_loss(outs, batch, cfg.head,
                   cfg.refine_assigner or cfg.assigner, canvas_hw)


def _make_ga_decode(cfg, canvas):
    from kgdet_tpu_torch.core.ga_loss import decode_detections_ga, \
        ga_squares
    H, W = canvas
    square_sets = {}                # the static squares, once a device

    def decode(outs, img_hw, scale_factor):
        dev = img_hw.device
        if dev not in square_sets:
            square_sets[dev] = [
                ga_squares(s, cfg.head.octave_base_scale, -(-H // s),
                           -(-W // s), device=dev)
                for s in cfg.head.point_strides]
        return decode_detections_ga(outs, cfg.head, canvas, img_hw,
                                    scale_factor, cfg.test,
                                    squares=square_sets[dev])
    return decode


HEAD_FAMILIES: Dict[str, HeadFamily] = {}


def register_head_family(name: str, family: HeadFamily):
    """Add ``family`` to the registry under ``name``; KeyError if the name
    is taken, as in the JAX package."""
    if name in HEAD_FAMILIES:
        raise KeyError(f'head family {name} already registered')
    HEAD_FAMILIES[name] = family


for _name, _family in {
    'KGDetHead': _point_family(_build_kgdet, _kgdet_loss),
    'KGDetHead1Rep': _point_family(_build_kgdet_1rep, _kgdet_loss),
    'SerialKpHead': _point_family(_build_serial(), _serial_loss),
    'ParallelKpHead': _point_family(_build_serial(parallel=True),
                                    _serial_loss),
    'RepPointsHead': _point_family(
        _build_serial(parallel=True, with_keypoints=False), _serial_loss),
    'RetinaHead': HeadFamily(build=_build_retina,
                             loss=_anchor_loss(_retina_loss),
                             make_decode=_make_anchor_decode),
    'SSDHead': HeadFamily(build=_build_ssd, loss=_anchor_loss(_ssd_loss),
                          make_decode=_make_anchor_decode),
    'FCOSHead': HeadFamily(build=_build_fcos, loss=_fcos_loss,
                           make_decode=_make_fcos_decode),
    'GARetinaHead': HeadFamily(build=_build_ga_retina, loss=_ga_retina_loss,
                               make_decode=_make_ga_decode),
}.items():
    register_head_family(_name, _family)

# the families whose detections carry a width-3 dummy keypoint
BOX_FAMILIES = ('RetinaHead', 'SSDHead', 'FCOSHead', 'GARetinaHead')


def get_head_family(name: str) -> HeadFamily:
    if name not in HEAD_FAMILIES:
        raise KeyError(
            f'unknown head family {name}; have {sorted(HEAD_FAMILIES)}')
    return HEAD_FAMILIES[name]


# --------------------------------------------------- two-stage family table
TWO_STAGE_TYPES = ('faster_rcnn', 'fast_rcnn', 'mask_rcnn', 'ms_rcnn',
                   'cascade_rcnn', 'double_head_rcnn', 'grid_rcnn', 'htc',
                   'rpn')


def is_two_stage(detector_type: str) -> bool:
    return detector_type in TWO_STAGE_TYPES


def two_stage_decoder(detector_type: str):
    """decode(fwd, img_hw, scale_factor, test_cfg, num_classes) of
    cfg.detector_type (the reference's simple_test equivalents); KeyError
    for an unknown name, as in the JAX package."""
    from kgdet_tpu_torch.core import two_stage_loss as tsl
    table = {
        'faster_rcnn': tsl.decode_rcnn_detections,
        'fast_rcnn': tsl.decode_rcnn_detections,
        'mask_rcnn': tsl.decode_rcnn_detections,
        'ms_rcnn': tsl.decode_rcnn_detections,
        'double_head_rcnn': tsl.decode_rcnn_detections,
        'cascade_rcnn': tsl.decode_cascade_detections,
        'grid_rcnn': tsl.decode_grid_detections,
        'htc': tsl.decode_htc_detections,
        'rpn': tsl.decode_rpn_proposals,
    }
    if detector_type not in table:
        raise KeyError(f'unknown two-stage detector {detector_type}')
    return table[detector_type]
