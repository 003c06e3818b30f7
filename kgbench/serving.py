"""What the serving drivers share: the program's model built with the
seed's weights, the capture of what a timed call produced, the traced
stretch, and the comparison with the plain reference once the window has
closed."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from kgbench import check, program, roofline, timeline, weights


def setup(cell, seed, device):
    """(config of the program, weights, reference module, model)."""
    spec = cell.config
    cfg = program.load_config(cell.root, spec)
    ref = cell.module('reference', spec['reference'])
    w = weights.make(ref.param_specs(spec['model']), seed, device)
    return cfg, w, ref, program.build(cfg, w, device)


class Capture:
    """Holds the model's last head outputs, read by a forward hook: the
    timed path runs unchanged, and a sampled call's outputs are kept."""

    def __init__(self, model):
        self.last = None
        self._h = model.register_forward_hook(self._hook)

    def _hook(self, _module, _args, out):
        self.last = out

    def close(self):
        self._h.remove()


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def reset_peak(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device):
    """The device's peak of allocated memory since ``reset_peak`` (0 off
    the card: a CPU run has no device memory to report)."""
    return torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0


def host_batch(batch, device):
    """A host batch as tensors, in pinned memory when the card will copy
    it."""
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: v.pin_memory() for k, v in out.items()} \
        if device.type == 'cuda' else out


def exact_float32():
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN, for the
    reference (set once the program's window is over)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def free():
    """Returns the memory of the program's state, which the caller has
    dropped, before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def stage_modules(model):
    return {'backbone': model.backbone, 'neck': model.neck,
            'head': model.bbox_head}


def traced_stretch(model, call, calls):
    """Runs ``call()`` ``calls`` times under the profiler with the stages'
    ranges, then ``calls`` times with synchronized stage spans: (timeline,
    stage ms lists)."""
    out = []
    for timed in (False, True):
        spans = timeline.StageSpans(stage_modules(model), 'decode', timed)

        def one():
            call()
            spans.end_call()
        with spans:
            if timed:
                for _ in range(calls):
                    one()
            else:
                out.append(timeline.profiled(one, calls))
    return out[0], dict(spans.ms)


def head_to_cpu(levels):
    return [{k: v.detach().float().cpu() for k, v in lvl.items()}
            for lvl in levels]


def reference_gaps(ref, decode, spec, samples, device):
    """head_gap and det_gap over the samples: per sample (image (B, 3, H, W)
    float32 normalized RGB, program head outputs, program detections as
    per-image valid rows, img_hw, scale_factor)."""
    exact_float32()
    w = {k: v.to(device) for k, v in samples['weights'].items()}
    model, test = spec['model'], spec['model']['test']
    heads, dets = 0.0, 0.0
    with torch.no_grad():
        for image, outs, rows, img_hw, sf in samples['items']:
            r = ref.forward(w, image.to(device), model)
            heads = max(heads, check.head_gap(outs, r))
            del r
            lv = [{k: v.to(device) for k, v in lvl.items()} for lvl in outs]
            decoded = decode.decode(lv, model['head']['point_strides'],
                                    img_hw, sf, test, torch.float32)
            dets = max(dets, check.det_gap(rows, check.valid_rows(*decoded)))
    return {'head_gap': heads, 'det_gap': dets}


def normalized(image_bgr_u8, img_hw, mean, std):
    """The reference's own normalization of uint8 BGR (B, H, W, 3) canvases:
    RGB, (x - mean) / std, zero outside each image's extents ->
    (B, 3, H, W) float32."""
    x = torch.as_tensor(image_bgr_u8).flip(-1).float()
    x = (x - torch.tensor(mean)) / torch.tensor(std)
    for b, (h, w) in enumerate(np.asarray(img_hw, np.int64)):
        x[b, h:] = 0
        x[b, :, w:] = 0
    return x.permute(0, 3, 1, 2).contiguous()


def wait_until(t):
    left = t - time.perf_counter()
    if left > 0:
        time.sleep(left)


def flops_per_image(ref, w, spec, canvas, device):
    """Model operations of one image on ``canvas``, counted over the
    reference's forward."""
    exact_float32()
    x = torch.zeros((1, 3) + tuple(canvas), device=device)
    with torch.no_grad():
        return roofline.model_flops(ref.forward, w, x, spec['model'])


def control_readings(cell, inputs, seed, device):
    """The control's head_gap (the reference's forward in float8) and
    det_gap (its decode in bfloat16) against the reference, over
    ``inputs`` (image, img_hw, scale_factor) as a run samples them."""
    spec = cell.config
    ref = cell.module('reference', spec['reference'])
    decode = cell.module('reference', spec['decode'])
    exact_float32()
    w = weights.make(ref.param_specs(spec['model']), seed, device)
    m = spec['model']
    strides = m['head']['point_strides']
    heads, dets = 0.0, 0.0
    with torch.no_grad():
        for x, img_hw, sf in inputs:
            x = x.to(device)
            r = ref.forward(w, x, m)
            heads = max(heads, check.head_gap(
                ref.forward(w, x, m, quant=ref.fp8), r))
            exact, low = (decode.decode(r, strides, img_hw, sf, m['test'], dt)
                          for dt in (torch.float32, torch.bfloat16))
            dets = max(dets, check.det_gap(check.valid_rows(*low),
                                           check.valid_rows(*exact)))
    return {'control': {'head_gap': heads, 'det_gap': dets}}
