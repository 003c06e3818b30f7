"""Detector composition: backbone -> neck -> head.

Port of kgdet_tpu/models/detector.py for the single-stage families of
models/families.py. Backbones: ``ResNet`` (with the DCN stages) and
``SSDVGG``; necks: ``FPN``, and ``Identity`` / ``None`` / ``'none'``, which
pass the backbone's levels to the head (the SSD recipes). Submodule names
are the reference's (backbone, neck, bbox_head), so the state_dict keys are
the reference checkpoint's.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from kgdet_tpu_torch.config import KGDetConfig
from kgdet_tpu_torch.models.families import IDENTITY_NECKS, \
    get_head_family
from kgdet_tpu_torch.models.fpn import FPN
from kgdet_tpu_torch.models.kgdet_head import KpRepBlock
from kgdet_tpu_torch.models.resnet import DeformConv3x3, ResNet
from kgdet_tpu_torch.models.serial_head import SerialKpHead
from kgdet_tpu_torch.models.vgg import SSDVGG


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
        self.neck = None if cfg.neck.type in IDENTITY_NECKS \
            else FPN.from_config(cfg.neck)
        self.bbox_head = get_head_family(cfg.head.type).build(cfg)

    def init_weights(self, seed: int = 0):
        """Seeded random weights, with the distributions of the JAX inits."""
        gen = torch.Generator().manual_seed(seed)
        for part in (self.backbone, self.neck, self.bbox_head):
            if part is not None:
                part.init_weights(gen)
        return self

    def use_plain_kernels(self, plain: bool = True):
        """Swap the kernels of the path (the frozen prefix's, the DCN
        stages' and the deformable head stages') for their plain PyTorch
        versions, or back: the reference a kernel run is checked against."""
        if isinstance(self.backbone, ResNet):
            self.backbone.plain_prefix = plain
        for m in self.modules():
            if isinstance(m, (KpRepBlock, SerialKpHead, DeformConv3x3)):
                m.plain = plain
        return self

    def forward(self, images):
        """images: (B, H, W, 3) normalized NHWC. Returns the per-level head
        dicts (see KGDetHead, SerialKpHead, RetinaHead, SSDHead)."""
        feats = self.backbone(images.to(self.dtype))
        return self.bbox_head(feats if self.neck is None
                              else self.neck(feats))


def build_backbone(bcfg):
    """The config's backbone: ``ResNet`` or ``SSDVGG``."""
    if bcfg.type == 'SSDVGG':
        return SSDVGG.from_config(bcfg)
    if bcfg.type != 'ResNet':
        raise NotImplementedError(
            f'backbone {bcfg.type!r} is not ported yet; ResNeXt and HRNet '
            'are queued in ROADMAP Queue 1 item 5.6')
    return ResNet.from_config(bcfg)
