"""Offline serving of a two-stage detector: one caller in a closed loop
sends whole batches, as the evaluation loader yields them, through the
program's ``api.make_predict_fn`` and takes each batch's detections to the
host, as ``serve_batches.py`` does for the cascade.

The window runs whole batches until ``seconds`` have passed and stops at
the end of the last one; ``serve_img_s`` is the images completed over the
window's seconds. A sampled batch keeps what the forward returned (the
RPN's outputs, the proposals, the box head's outputs) beside its
detections. With tracing, a stretch of ``traced_batches`` more batches
runs with stage spans under the profiler, then in the program's own spans
(``kgbench/program_trace.py``). Then the program is freed and each stage of
the sampled batches is held against the plain reference
(``kgbench/check_rcnn.py``): the RPN's outputs against the reference's
forward, and each later stage against the reference applied to what the
program's previous stage produced.
"""
from __future__ import annotations

import time

import torch

from kgbench import check, check_rcnn, program_trace, roofline, serving, \
    traffic, weights
from kgbench.drivers.serve_batches import control_inputs

GAPS = ('rpn_gap', 'proposal_gap', 'roi_gap', 'det_gap')


def run(cell, seed, seconds, trace, t0, device):
    from kgdet_tpu_torch.api import make_predict_fn
    spec, mix = cell.config, cell.traffic
    cfg, w, ref, model = serving.setup(cell, seed, device)
    batches, order = traffic.offline_batches(mix, spec['data'], seed)
    host = [serving.host_batch(b, device) for b in batches]
    canvases = {tuple(b['image'].shape[1:3]) for b in batches}
    predict = {c: make_predict_fn(model, cfg, c) for c in canvases}

    def serve(i):
        b = host[order[i % len(order)]]
        dets = predict[tuple(b['image'].shape[1:3])](b)
        return {k: v.cpu() for k, v in dets.items()}

    for i in range(len(order) * mix['warmup_rounds']):
        serve(i)
    cap = serving.Capture(model)
    # the sampled batches: one of each pool batch among the first round
    sampled = set(traffic.sample(seed, range(len(order)),
                                 mix['sampled_batches']))
    kept = []
    serving.reset_peak(device)
    setup_s = time.perf_counter() - t0

    n, start = 0, time.perf_counter()
    while True:
        dets = serve(n)
        if n in sampled:
            kept.append((order[n % len(order)], forward_to_cpu(cap.last),
                         dets))
        n += 1
        elapsed = time.perf_counter() - start
        if elapsed >= seconds:
            break
    peak = serving.peak_bytes(device)
    obs = {'images': n * mix['batch'], 'seconds': elapsed,
           'batch': mix['batch'], 'model': spec['model'],
           'canvases': sorted(canvases)}
    if trace:
        k = [n]

        def one():
            serve(k[0])
            k[0] += 1
        obs['timeline'], obs['stage_ms'] = serving.traced_stretch(
            model, one, mix['traced_batches'])
        obs['program_trace'] = program_trace.stretches(
            one, mix['traced_batches'])
        obs['flops_per_image'] = flops_per_image(
            ref, w, spec['model'], sorted(canvases)[0], device)
    cap.close()
    del model, predict, host, cap
    serving.free()

    items = []
    for idx, fwd, dets in kept:
        b = batches[idx]
        items.append((serving.normalized(b['image'], b['img_hw'],
                                         spec['model']['img_mean'],
                                         spec['model']['img_std']),
                      fwd,
                      check_rcnn.valid_rows(*(dets[k].numpy() for k in (
                          'det_bboxes', 'det_labels', 'valid'))),
                      b['img_hw'], b['scale_factor']))
    readings = reference_gaps(ref, cell.module('reference', spec['decode']),
                              spec, w, items, device)
    correct, rows = check.judge(readings, spec['limits'])
    correct = correct and len(kept) == len(sampled)
    return {'correct': correct, 'attempted': n * mix['batch'], 'failed': 0,
            'e2e': {'serve_img_s': n * mix['batch'] / elapsed,
                    'peak_mem_gib': peak / 2 ** 30, 'setup_s': setup_s},
            'obs': obs, 'checks': rows, 'peak_bytes': peak}


def forward_to_cpu(fwd):
    """What a sampled call's forward returned, as float32 (bool for the
    proposals' presence) on the host: the RPN's outputs per level (B, h, w,
    X), the proposals, the box head's logits and deltas."""
    def host(t):
        return t.detach().float().cpu()
    return {'rpn': [{k: host(lvl[k][-1]) for k in ('cls', 'bbox')}
                    for lvl in fwd['rpn_outs']],
            'proposals': host(fwd['proposals']),
            'valid': fwd['proposal_valid'].detach().cpu(),
            'roi_cls': host(fwd['roi_cls']), 'roi_reg': host(fwd['roi_reg'])}


def _rpn_args(model):
    r = model['rpn']
    return dict(nms_pre=r['nms_pre'], max_num=r['max_num'],
                nms_thr=r['nms_thr'])


def reference_gaps(ref, decode, spec, w, items, device):
    """The four gaps over the samples: per sample (image (B, 3, H, W)
    float32 normalized RGB, ``forward_to_cpu`` of the program, the
    program's detections as per-image valid rows, img_hw, scale_factor)."""
    serving.exact_float32()
    w = {k: v.to(device) for k, v in w.items()}
    m = spec['model']
    worst = dict.fromkeys(GAPS, 0.0)
    anchors = {}
    with torch.no_grad():
        for image, fwd, rows, img_hw, sf in items:
            canvas = tuple(image.shape[2:])
            if canvas not in anchors:
                anchors[canvas] = ref.anchors(m, canvas, device)
            hw = torch.as_tensor(img_hw, device=device)
            p = {k: v.to(device) for k, v in fwd.items() if k != 'rpn'}
            p_rpn = [{k: v.to(device) for k, v in lvl.items()}
                     for lvl in fwd['rpn']]
            r = ref.forward(w, image.to(device), m)
            gaps = {'rpn_gap': check_rcnn.norm_gap(
                check_rcnn.rpn_pairs(p_rpn, r['rpn']))}
            props, valid = ref.proposals(p_rpn, anchors[canvas], hw,
                                         **_rpn_args(m))
            gaps['proposal_gap'] = check_rcnn.proposal_gap(
                fwd['proposals'].numpy(), fwd['valid'].numpy(),
                props.cpu().numpy(), valid.cpu().numpy())
            cls, reg = ref.roi_head(w, r['feats'], p['proposals'], p['valid'],
                                    m)
            gaps['roi_gap'] = check_rcnn.norm_gap(
                [(p['roi_cls'], cls), (p['roi_reg'], reg)])
            del r, cls, reg
            dets = decode.decode(p['roi_cls'], p['roi_reg'], p['proposals'],
                                 p['valid'], hw,
                                 torch.as_tensor(sf, device=device),
                                 m['test'], torch.float32)
            gaps['det_gap'] = check_rcnn.det_gap(
                rows, check_rcnn.valid_rows(*dets))
            worst = {k: max(v, gaps[k]) for k, v in worst.items()}
    return worst


def flops_per_image(ref, w, model, canvas, device):
    """Model operations of one image on ``canvas``, counted over the
    reference: the forward, and the RoI head at the configuration's
    proposals an image, all present or not."""
    serving.exact_float32()
    x = torch.zeros((1, 3) + tuple(canvas), device=device)
    R = model['rpn']['max_num']
    with torch.no_grad():
        trunk = roofline.model_flops(ref.forward, w, x, model)
        feats = ref.forward(w, x, model)['feats']
        head = roofline.model_flops(
            ref.roi_head, w, feats, torch.zeros((1, R, 4), device=device),
            torch.zeros((1, R), dtype=torch.bool, device=device), model)
    return trunk + head


def control_readings(cell, seed, device):
    """On the inputs a run samples, the readings of the control (the
    reference's forward in float8 for ``rpn_gap`` and ``roi_gap``, its
    proposals and decode in bfloat16) and of two planted faults (each RoI
    aligned on its neighbouring level; the proposals' NMS at IoU 0.75),
    each against the float32 reference."""
    spec = cell.config
    m = spec['model']
    ref = cell.module('reference', spec['reference'])
    decode = cell.module('reference', spec['decode'])
    serving.exact_float32()
    w = weights.make(ref.param_specs(m), seed, device)
    out = {'control': dict.fromkeys(GAPS, 0.0),
           'neighbour_level': {'roi_gap': 0.0},
           'proposals_nms_0.75': {'proposal_gap': 0.0}}

    def worst(side, name, value):
        out[side][name] = max(out[side][name], value)
    anchors = {}
    with torch.no_grad():
        for x, img_hw, sf in control_inputs(cell, seed):
            canvas = tuple(x.shape[2:])
            if canvas not in anchors:
                anchors[canvas] = ref.anchors(m, canvas, device)
            hw = torch.as_tensor(img_hw, device=device)
            sf = torch.as_tensor(sf, device=device)
            x = x.to(device)
            r = ref.forward(w, x, m)
            low = ref.forward(w, x, m, quant=ref.fp8)
            worst('control', 'rpn_gap', check_rcnn.norm_gap(
                check_rcnn.rpn_pairs(low['rpn'], r['rpn'])))
            props, valid = ref.proposals(r['rpn'], anchors[canvas], hw,
                                         **_rpn_args(m))
            exact = (props.cpu().numpy(), valid.cpu().numpy())
            for side, kw in (('control', {'dtype': torch.bfloat16}),
                             ('proposals_nms_0.75', {'nms_thr': 0.75})):
                p, v = ref.proposals(r['rpn'], anchors[canvas], hw,
                                     **dict(_rpn_args(m), **kw))
                worst(side, 'proposal_gap', check_rcnn.proposal_gap(
                    p.cpu().numpy(), v.cpu().numpy(), *exact))
            cls, reg = ref.roi_head(w, r['feats'], props, valid, m)
            lcls, lreg = ref.roi_head(w, low['feats'], props, valid, m,
                                      quant=ref.fp8)
            worst('control', 'roi_gap', check_rcnn.norm_gap(
                [(lcls, cls), (lreg, reg)]))
            top = len(r['feats']) - 1
            lvl = ref.roi_levels(props, top + 1, m['roi']['finest_scale'])
            ncls, nreg = ref.roi_head(
                w, r['feats'], props, valid, m,
                levels=torch.where(lvl < top, lvl + 1, lvl - 1))
            worst('neighbour_level', 'roi_gap', check_rcnn.norm_gap(
                [(ncls, cls), (nreg, reg)]))
            del r, low
            rows = [check_rcnn.valid_rows(*decode.decode(
                cls, reg, props, valid, hw, sf, m['test'], dt))
                for dt in (torch.float32, torch.bfloat16)]
            worst('control', 'det_gap', check_rcnn.det_gap(rows[1], rows[0]))
    return out
