"""Head-family records: build + decode per single-stage head family.

Port of kgdet_tpu/models/families.py for the serving path: only the
``KGDetHead`` record (the loss entry comes with training). Every other family
raises ``NotImplementedError`` naming the ROADMAP queue that ports it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

from kgdet_tpu_torch.ops.points import grid_points


@dataclass(frozen=True)
class HeadFamily:
    """build(cfg) -> head module; make_decode(cfg, canvas) ->
    decode(outs, img_hw, scale_factor) -> padded detections."""
    build: Callable
    make_decode: Callable


def level_grids(cfg, canvas_hw, device=None):
    """Static per-level (H*W, 3) grids for a padded canvas."""
    H, W = canvas_hw
    return [grid_points(-(-H // s), -(-W // s), s, device=device)
            for s in cfg.head.point_strides]


def _build_kgdet(cfg):
    from kgdet_tpu_torch.models.kgdet_head import KGDetHead
    return KGDetHead.from_config(cfg)


def _make_point_decode(cfg, canvas):
    from kgdet_tpu_torch.core.postprocess import decode_detections

    def decode(outs, img_hw, scale_factor):
        grids = level_grids(cfg, canvas, device=img_hw.device)
        return decode_detections(outs, grids, img_hw, scale_factor,
                                 cfg.test, num_keypts=cfg.head.num_keypts)
    return decode


HEAD_FAMILIES: Dict[str, HeadFamily] = {
    'KGDetHead': HeadFamily(build=_build_kgdet,
                            make_decode=_make_point_decode),
}


def get_head_family(name: str) -> HeadFamily:
    if name not in HEAD_FAMILIES:
        raise NotImplementedError(
            f'head family {name!r} is not ported yet; the other single-stage '
            'families are queued in ROADMAP Queue 1 item 5')
    return HEAD_FAMILIES[name]
