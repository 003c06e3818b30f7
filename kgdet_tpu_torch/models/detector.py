"""Detector composition: backbone -> neck -> head.

Port of kgdet_tpu/models/detector.py for the single-stage KGDet family.
Submodule names are the reference's (backbone, neck, bbox_head), so the
state_dict keys are the reference checkpoint's.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from kgdet_tpu.config import KGDetConfig
from kgdet_tpu_torch.models.families import get_head_family
from kgdet_tpu_torch.models.fpn import FPN
from kgdet_tpu_torch.models.kgdet_head import KpRepBlock
from kgdet_tpu_torch.models.resnet import ResNet


def compute_dtype(cfg: KGDetConfig):
    return torch.bfloat16 if cfg.compute_dtype == 'bfloat16' \
        else torch.float32


class KGDetDetector(nn.Module):
    """backbone -> neck -> head, all three resolved from the config."""

    def __init__(self, cfg: KGDetConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.backbone = ResNet.from_config(cfg.backbone)
        self.neck = FPN.from_config(cfg.neck)
        self.bbox_head = get_head_family(cfg.head.type).build(cfg)

    def init_weights(self, seed: int = 0):
        """Seeded random weights, with the distributions of the JAX inits."""
        gen = torch.Generator().manual_seed(seed)
        self.backbone.init_weights(gen)
        self.neck.init_weights(gen)
        self.bbox_head.init_weights(gen)
        return self

    def use_plain_kernels(self, plain: bool = True):
        """Swap the kernels of the path (K1, K4, K5) for their plain
        PyTorch versions, or back: the reference a kernel run is checked
        against."""
        self.backbone.plain_prefix = plain
        for m in self.modules():
            if isinstance(m, KpRepBlock):
                m.plain = plain
        return self

    def forward(self, images):
        """images: (B, H, W, 3) normalized NHWC. Returns the per-level head
        dicts (see KGDetHead)."""
        feats = self.backbone(images.to(self.dtype))
        return self.bbox_head(self.neck(feats))
