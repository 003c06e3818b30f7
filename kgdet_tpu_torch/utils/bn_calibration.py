"""FrozenBatchNorm statistic calibration for from-scratch training.

Port of kgdet_tpu/utils/bn_calibration.py. The KGDet trunk runs BatchNorm
with permanently frozen statistics (norm_eval, reference resnet.py:518-525)
— correct when loading pretrained running stats, but from random init the
frozen identity stats leave a deep ResNet unnormalized.

``calibrate_frozen_bn`` is the from-scratch analog of loading pretrained
stats: it runs the model over a few batches, takes every FrozenBatchNorm's
input moments (a forward pre-hook: the input cast to f32, reduced over N,
H and W; a module called more than once in a forward counts its first
call, as the JAX package reads the first of its sown values), pools them
exactly (law of total variance), and writes the result into the module's
``running_mean`` / ``running_var`` in place.

The frozen prefix of a ResNet (stem and layer1 as the K4 / K5 or K8
kernels) reads its BNs folded into the convs, so no hook would see their
inputs: while moments are taken every ResNet runs its unfolded chain, as
the JAX ResNet leaves its fused prefix when moments are sown
(kgdet_tpu/models/resnet.py:382, :440). The in-place writes change the
buffers' ``_version``, so ``ResNet.prefix_weights`` refolds on the next
served batch.
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from kgdet_tpu_torch.models.layers import FrozenBatchNorm
from kgdet_tpu_torch.ops.image import device_normalize


def calibrate_frozen_bn(model, batches: Iterable, passes: int = 1) -> int:
    """Set every reached FrozenBatchNorm's running stats to the moments of
    its input over ``batches``; returns the number of BNs set.

    batches: image arrays (each (B, H, W, 3): uint8 BGR, normalized on the
    device as a served batch is, or floats already normalized), or tensors.
    Moments are pooled over all batches, and a pass writes its stats only
    after all of them. passes > 1 re-measures with the previous pass's
    stats applied. On a deep residual trunk that feedback diverges (the
    JAX package measured pass-2 variances of ~1e11 on R-50); the default
    single pass fixes the gross scale problem.
    """
    batches = list(batches)
    applied = 0
    for _ in range(max(passes, 1)):
        applied = _calibrate_once(model, batches)
    return applied


def _calibrate_once(model, batches) -> int:
    from kgdet_tpu_torch.models.resnet import ResNet

    dev = next(model.parameters()).device
    bns = [m for m in model.modules() if isinstance(m, FrozenBatchNorm)]
    moments = {m: [] for m in bns}
    seen = set()

    def hook(module, args):
        if module in seen:
            return
        seen.add(module)
        xf = args[0].float()
        dims = (0, 2, 3)
        moments[module].append(
            (xf.mean(dim=dims).double().cpu().numpy(),
             xf.var(dim=dims, unbiased=False).double().cpu().numpy()))

    resnets = [m for m in model.modules() if isinstance(m, ResNet)]
    kept = [r.use_prefix for r in resnets]
    handles = [m.register_forward_pre_hook(hook) for m in bns]
    try:
        for r in resnets:
            r.use_prefix = False
        with torch.no_grad():
            for images in batches:
                seen.clear()
                model(device_normalize(torch.as_tensor(images).to(dev)))
    finally:
        for h in handles:
            h.remove()
        for r, use in zip(resnets, kept):
            r.use_prefix = use

    applied = 0
    with torch.no_grad():
        for m, ms in moments.items():
            if not ms:
                continue
            means = np.stack([a for a, _ in ms])
            vars_ = np.stack([v for _, v in ms])
            # exact pooling: E[x^2] - E[x]^2 across equally-sized batches
            mean = means.mean(axis=0)
            var = (vars_ + means ** 2).mean(axis=0) - mean ** 2
            m.running_mean.copy_(torch.from_numpy(mean.astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                np.maximum(var, 1e-6).astype(np.float32)))
            applied += 1
    return applied
