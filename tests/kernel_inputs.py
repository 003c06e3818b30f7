"""Kernel inputs that tests/test_torch_gpu.py and chip_smoke.py share."""
from __future__ import annotations

import torch


def nms_boxes(gen, B, N, hw=(800, 1344)):
    """(B, N, 4) xyxy f32 boxes in the served decode's range on an ``hw``
    canvas, on the CPU: clustered around 20 centres an image, so that a
    row's boxes overlap heavily, clamped to the image as decode_raw clamps
    them."""
    H, W = (float(v) for v in hw)
    centre = torch.rand((B, 20, 2), generator=gen) * torch.tensor([W, H])
    pick = torch.randint(0, 20, (B, N), generator=gen)
    c = centre.gather(1, pick[..., None].expand(B, N, 2)) \
        + torch.randn((B, N, 2), generator=gen) * 30
    wh = 20 + torch.rand((B, N, 2), generator=gen) * 380
    xy = torch.cat([c - wh / 2, c + wh / 2], -1)
    return torch.minimum(xy.clamp(min=0), torch.tensor([W, H, W, H]))
