"""Detector composition: backbone -> neck -> head.

Port of kgdet_tpu/models/detector.py for the single-stage families of
models/families.py. Backbones and necks are resolved by type through the
registries of config.py, as in the JAX package: ``ResNet``, ``ResNeXt``,
``SSDVGG`` and ``HRNet``; ``FPN``, ``HRFPN``, ``BFP`` and ``FPNBFP``, and
``Identity`` / ``None`` / ``'none'``, which pass the backbone's levels to
the head (the SSD recipes). Submodule names are the reference's (backbone,
neck, bbox_head), so the state_dict keys are the reference checkpoint's.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from kgdet_tpu_torch.config import BACKBONES, NECKS, KGDetConfig
from kgdet_tpu_torch.models.families import IDENTITY_NECKS, \
    get_head_family
from kgdet_tpu_torch.models.fpn import FPN
from kgdet_tpu_torch.models.hrnet import HRNet
from kgdet_tpu_torch.models.necks_extra import BFP, FPNBFP, HRFPN
from kgdet_tpu_torch.models.resnet import ResNet, ResNeXt
from kgdet_tpu_torch.models.vgg import SSDVGG
from kgdet_tpu_torch.utils.trace import span

for _cls in (ResNet, ResNeXt, SSDVGG, HRNet):
    BACKBONES.register(_cls)
for _cls in (FPN, HRFPN, FPNBFP, BFP):
    NECKS.register(_cls)


def compute_dtype(cfg: KGDetConfig):
    return torch.bfloat16 if cfg.compute_dtype == 'bfloat16' \
        else torch.float32


class KGDetDetector(nn.Module):
    """backbone -> neck -> head, all three resolved from the config."""

    def __init__(self, cfg: KGDetConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.backbone = build_backbone(cfg.backbone)
        self.neck = build_neck(cfg.neck)
        self.bbox_head = get_head_family(cfg.head.type).build(cfg)

    def init_weights(self, seed: int = 0):
        """Seeded random weights, with the distributions of the JAX inits."""
        gen = torch.Generator().manual_seed(seed)
        for part in (self.backbone, self.neck, self.bbox_head):
            if part is not None:
                part.init_weights(gen)
        return self

    def forward(self, images):
        """images: (B, H, W, 3) normalized NHWC. Returns the per-level head
        dicts (see KGDetHead, SerialKpHead, RetinaHead, SSDHead)."""
        with span('backbone'):
            feats = self.backbone(images.to(self.dtype))
        if self.neck is not None:
            with span('neck'):
                feats = self.neck(feats)
        with span('head'):
            return self.bbox_head(feats)


def build_backbone(bcfg):
    """The config's backbone, by its type."""
    return BACKBONES.get(bcfg.type).from_config(bcfg)


def build_neck(ncfg):
    """The config's neck, by its type; None for the identity necks, whose
    callers feed the backbone's levels to the head."""
    if ncfg.type in IDENTITY_NECKS:
        return None
    return NECKS.get(ncfg.type).from_config(ncfg)
