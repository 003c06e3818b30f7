"""Head-family records: build + decode per single-stage head family.

Port of kgdet_tpu/models/families.py: the records of the point-based
families (build, loss, decode): ``KGDetHead`` and its single-column ablation
``KGDetHead1Rep``, and the init/refine heads ``SerialKpHead``,
``ParallelKpHead`` and ``RepPointsHead``. Every other family raises
``NotImplementedError`` naming the ROADMAP queue that ports it.
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

    def decode(outs, img_hw, scale_factor):
        grids = level_grids(cfg, canvas, device=img_hw.device)
        return decode_detections(outs, grids, img_hw, scale_factor,
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


HEAD_FAMILIES: Dict[str, HeadFamily] = {
    'KGDetHead': _point_family(_build_kgdet, _kgdet_loss),
    'KGDetHead1Rep': _point_family(_build_kgdet_1rep, _kgdet_loss),
    'SerialKpHead': _point_family(_build_serial(), _serial_loss),
    'ParallelKpHead': _point_family(_build_serial(parallel=True),
                                    _serial_loss),
    'RepPointsHead': _point_family(
        _build_serial(parallel=True, with_keypoints=False), _serial_loss),
}


def get_head_family(name: str) -> HeadFamily:
    if name not in HEAD_FAMILIES:
        raise NotImplementedError(
            f'head family {name!r} is not ported yet; the other single-stage '
            'families are queued in ROADMAP Queue 1 item 5')
    return HEAD_FAMILIES[name]
