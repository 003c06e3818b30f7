"""Offline serving of HTC: one caller in a closed loop sends whole batches,
as the evaluation loader yields them, through the program's
``api.make_predict_fn`` and takes each batch's detections, labels and
28 x 28 mask probabilities to the host, as ``serve_rcnn_batches.py`` does
for Faster R-CNN.

The window runs whole batches until ``seconds`` have passed and stops at
the end of the last one; ``serve_img_s`` is the images completed over the
window's seconds. A sampled batch keeps what the forward returned (the
RPN's outputs, the proposals, each box stage's RoIs and outputs, the mask
RoIs and logits, the semantic branch's outputs) beside its detections.
With tracing, a stretch of ``traced_batches`` more batches runs with stage
spans under the profiler, then in the program's own spans
(``kgbench/program_trace.py``). Then the program is freed and each stage
of the sampled batches is held against the plain reference
(``kgbench/reference/htc.py``, ``htc_decode.py``), each against the
reference applied to what the program's previous stage produced:

- ``rpn_gap``: the RPN's outputs against the reference's forward;
- ``proposal_gap``: the proposals against the reference's from the
  program's RPN outputs, and each later stage's RoIs against the
  reference's refinement of the program's stage before (coordinates per
  1000 px; a slot whose presence differs counts 1);
- ``sem_gap``: the semantic branch's stuff logits and embedding against
  the reference's forward;
- ``stage_gap``: the worst of the three box stages' logits and deltas,
  each on the reference's float32 features at the program's own RoIs of
  that stage;
- ``mask_gap``: the stages' averaged mask logits on the reference's
  features at the program's own mask boxes;
- ``det_gap``: the detections against the reference decode of the
  program's own stage outputs and mask logits, as Faster R-CNN's, and
  each detection's 28 x 28 mask probabilities (their largest difference).

The network gaps are ``check_rcnn.norm_gap``'s.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from kgbench import check, check_rcnn, program_trace, roofline, serving, \
    traffic, weights
from kgbench.drivers.serve_batches import control_inputs
from kgbench.drivers.serve_rcnn_batches import _rpn_args

GAPS = ('rpn_gap', 'proposal_gap', 'sem_gap', 'stage_gap', 'mask_gap',
        'det_gap')
DET_KEYS = ('det_bboxes', 'det_labels', 'det_masks', 'valid')


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
    cap, sem = serving.Capture(model), serving.Capture(model.semantic_head)
    sampled = set(traffic.sample(seed, range(len(order)),
                                 mix['sampled_batches']))
    kept = []
    serving.reset_peak(device)
    setup_s = time.perf_counter() - t0

    n, start = 0, time.perf_counter()
    while True:
        dets = serve(n)
        if n in sampled:
            kept.append((order[n % len(order)],
                         forward_to_cpu(cap.last, sem.last), dets))
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
        # the stages of the other cells, HTC's head its last mask head:
        # the decode is what follows it
        stages = SimpleNamespace(backbone=model.backbone, neck=model.neck,
                                 bbox_head=model.mask_head[-1])
        obs['timeline'], obs['stage_ms'] = serving.traced_stretch(
            stages, one, mix['traced_batches'])
        obs['program_trace'] = program_trace.stretches(
            one, mix['traced_batches'])
        obs['flops_per_image'] = flops_per_image(
            ref, w, spec['model'], sorted(canvases)[0], device)
    cap.close()
    sem.close()
    del model, predict, host, cap, sem
    serving.free()

    items = []
    for idx, fwd, dets in kept:
        b = batches[idx]
        items.append((serving.normalized(b['image'], b['img_hw'],
                                         spec['model']['img_mean'],
                                         spec['model']['img_std']),
                      fwd, valid_rows(*(dets[k].numpy() for k in DET_KEYS)),
                      b['img_hw'], b['scale_factor']))
    readings = reference_gaps(ref, cell.module('reference', spec['decode']),
                              spec, w, items, device)
    correct, rows = check.judge(readings, spec['limits'])
    correct = correct and len(kept) == len(sampled)
    return {'correct': correct, 'attempted': n * mix['batch'], 'failed': 0,
            'e2e': {'serve_img_s': n * mix['batch'] / elapsed,
                    'peak_mem_gib': peak / 2 ** 30, 'setup_s': setup_s},
            'obs': obs, 'checks': rows, 'peak_bytes': peak}


def forward_to_cpu(fwd, sem):
    """What a sampled call's forward returned, as float32 (bool for
    presence) on the host: the RPN's outputs per level (B, h, w, X), the
    proposals, each stage's RoIs, logits and deltas, the mask RoIs and their
    averaged logits; and the semantic branch's (logits, embedding) (B, H, W,
    X)."""
    def host(t):
        return t.detach().float().cpu()
    return {'rpn': [{k: host(lvl[k][-1]) for k in ('cls', 'bbox')}
                    for lvl in fwd['rpn_outs']],
            'proposals': host(fwd['proposals']),
            'valid': fwd['proposal_valid'].detach().cpu(),
            'stages': [tuple(host(s[k]) for k in ('proposals', 'roi_cls',
                                                  'roi_reg'))
                       for s in fwd['stages']],
            'mask_boxes': host(fwd['mask_boxes']),
            'mask_valid': fwd['mask_valid'].detach().cpu(),
            'mask_logits': host(fwd['mask_logits']),
            'semantic': tuple(host(t) for t in sem)}


def valid_rows(det_bboxes, det_labels, det_masks, valid):
    """Padded detections (B, M, ...) -> per image its valid rows (boxes,
    labels, masks)."""
    return [tuple(np.asarray(a[b])[np.asarray(valid[b], bool)]
                  for a in (det_bboxes, det_labels, det_masks))
            for b in range(len(valid))]


def det_gap(program, reference):
    """``check_rcnn.det_gap`` of the boxes, scores and labels, and the
    largest difference of a detection's mask probabilities; per image
    (boxes (n, 5), labels (n,), masks (n, S, S)) numpy."""
    gap = check_rcnn.det_gap([r[:2] for r in program],
                             [r[:2] for r in reference])
    for (_, _, pm), (_, _, rm) in zip(program, reference, strict=True):
        if pm.shape != rm.shape:
            return 1.0
        if len(pm):
            d = float(np.abs(pm - rm).max())
            gap = max(gap, d if np.isfinite(d) else 1.0)
    return gap


def stage_rois_gap(stages, valid, img_hw, ref, m):
    """Each later stage's RoIs against the reference's refinement of the
    stage before (``check_rcnn.proposal_gap``)."""
    v = valid.cpu().numpy()
    worst = 0.0
    for i in range(1, len(stages)):
        rois, _, reg = stages[i - 1]
        mine = ref.next_rois(rois, reg, img_hw, m, i - 1)
        worst = max(worst, check_rcnn.proposal_gap(
            stages[i][0].cpu().numpy(), v, mine.cpu().numpy(), v))
    return worst


def reference_gaps(ref, decode, spec, w, items, device):
    """The six gaps over the samples: per sample (image (B, 3, H, W)
    float32 normalized RGB, ``forward_to_cpu`` of the program, the
    program's detections as ``valid_rows``, img_hw, scale_factor)."""
    serving.exact_float32()
    w = {k: v.to(device) for k, v in w.items()}
    m = spec['model']
    worst = dict.fromkeys(GAPS, 0.0)
    anchors = {}

    def dev(t):
        return t.to(device)
    with torch.no_grad():
        for image, fwd, rows, img_hw, sf in items:
            canvas = tuple(image.shape[2:])
            if canvas not in anchors:
                anchors[canvas] = ref.anchors(m, canvas, device)
            hw = torch.as_tensor(img_hw, device=device)
            p_rpn = [{k: dev(v) for k, v in lvl.items()}
                     for lvl in fwd['rpn']]
            valid = dev(fwd['valid'])
            stages = [tuple(dev(t) for t in s) for s in fwd['stages']]
            r = ref.forward(w, dev(image), m)
            gaps = {'rpn_gap': check_rcnn.norm_gap(
                check_rcnn.rpn_pairs(p_rpn, r['rpn']))}
            props, pvalid = ref.proposals(p_rpn, anchors[canvas], hw,
                                          **_rpn_args(m))
            gaps['proposal_gap'] = max(
                check_rcnn.proposal_gap(
                    fwd['proposals'].numpy(), fwd['valid'].numpy(),
                    props.cpu().numpy(), pvalid.cpu().numpy()),
                stage_rois_gap(stages, valid, hw, ref, m))
            logits, emb = ref.semantic(w, r['feats'], m)
            gaps['sem_gap'] = check_rcnn.norm_gap(
                [(dev(fwd['semantic'][0]), logits),
                 (dev(fwd['semantic'][1]), emb)])
            del logits
            gaps['stage_gap'] = max(check_rcnn.norm_gap(list(zip(
                (cls, reg), ref.box_stage(w, r['feats'], emb, rois, valid,
                                          m, i))))
                for i, (rois, cls, reg) in enumerate(stages))
            gaps['mask_gap'] = check_rcnn.norm_gap([(
                dev(fwd['mask_logits']),
                ref.mask_heads(w, r['feats'], emb, dev(fwd['mask_boxes']),
                               dev(fwd['mask_valid']), m))])
            del r, emb
            dets = decode.decode(stages, valid, dev(fwd['mask_logits']), hw,
                                 torch.as_tensor(sf, device=device), m,
                                 torch.float32)
            gaps['det_gap'] = det_gap(rows, valid_rows(*dets))
            worst = {k: max(v, gaps[k]) for k, v in worst.items()}
    return worst


def flops_per_image(ref, w, model, canvas, device):
    """Model operations of one image on ``canvas``, counted over the
    reference: the forward, the semantic branch, the three box stages at
    the configuration's proposals an image and the mask heads at its mask
    RoIs, all present or not."""
    serving.exact_float32()
    x = torch.zeros((1, 3) + tuple(canvas), device=device)
    R, K = model['rpn']['max_num'], model['mask']['rois']
    with torch.no_grad():
        total = roofline.model_flops(ref.forward, w, x, model)
        feats = ref.forward(w, x, model)['feats']
        total += roofline.model_flops(ref.semantic, w, feats, model)
        emb = ref.semantic(w, feats, model)[1]
        for i in range(len(model['cascade']['stds'])):
            total += roofline.model_flops(
                ref.box_stage, w, feats, emb,
                torch.zeros((1, R, 4), device=device),
                torch.zeros((1, R), dtype=torch.bool, device=device), model,
                i)
        total += roofline.model_flops(
            ref.mask_heads, w, feats, emb,
            torch.zeros((1, K, 4), device=device),
            torch.zeros((1, K), dtype=torch.bool, device=device), model)
    return total


def _reference_stages(ref, w, feats, emb, props, valid, hw, m):
    """The reference's own three stages from its proposals: per stage
    (rois, cls, reg)."""
    stages, rois = [], props
    for i in range(len(m['cascade']['stds'])):
        cls, reg = ref.box_stage(w, feats, emb, rois, valid, m, i)
        stages.append((rois, cls, reg))
        rois = ref.next_rois(rois, reg, hw, m, i)
    return stages


def control_readings(cell, seed, device):
    """On the inputs a run samples, the readings of the control (the
    reference's forward, semantic branch, box stages and mask heads in
    float8 for the network gaps; its proposals and decode in bfloat16) and
    of three planted faults (each box RoI aligned on its neighbouring
    level; stages 2 and 3's mask heads without the information flow; the
    proposals' NMS at IoU 0.75), each against the float32 reference on
    its own stages."""
    spec = cell.config
    m = spec['model']
    ref = cell.module('reference', spec['reference'])
    decode = cell.module('reference', spec['decode'])
    serving.exact_float32()
    w = weights.make(ref.param_specs(m), seed, device)
    out = {'control': dict.fromkeys(GAPS, 0.0),
           'neighbour_level': {'stage_gap': 0.0},
           'no_info_flow': {'mask_gap': 0.0},
           'proposals_nms_0.75': {'proposal_gap': 0.0}}

    def worst(side, name, value):
        out[side][name] = max(out[side][name], value)
    anchors = {}
    top = len(m['rpn']['strides']) - 1

    def neighbour(rois):
        lvl = ref.roi_levels(rois, top + 1, m['roi']['finest_scale'])
        return torch.where(lvl < top, lvl + 1, lvl - 1)
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
            sem = ref.semantic(w, r['feats'], m)
            lsem = ref.semantic(w, low['feats'], m, quant=ref.fp8)
            worst('control', 'sem_gap', check_rcnn.norm_gap(
                list(zip(lsem, sem))))
            emb = sem[1]
            del sem
            stages = _reference_stages(ref, w, r['feats'], emb, props,
                                       valid, hw, m)
            for i, (rois, cls, reg) in enumerate(stages):
                for side, got in (
                        ('control', ref.box_stage(
                            w, low['feats'], lsem[1], rois, valid, m, i,
                            quant=ref.fp8)),
                        ('neighbour_level', ref.box_stage(
                            w, r['feats'], emb, rois, valid, m, i,
                            levels=neighbour(rois)))):
                    worst(side, 'stage_gap', check_rcnn.norm_gap(
                        list(zip(got, (cls, reg)))))
            boxes, _, mvalid = decode.select(stages, valid, m)
            logits = ref.mask_heads(w, r['feats'], emb, boxes, mvalid, m)
            for side, got in (
                    ('control', ref.mask_heads(w, low['feats'], lsem[1],
                                               boxes, mvalid, m,
                                               quant=ref.fp8)),
                    ('no_info_flow', ref.mask_heads(
                        w, r['feats'], emb, boxes, mvalid, m,
                        info_flow=False))):
                worst(side, 'mask_gap', check_rcnn.norm_gap(
                    [(got, logits)]))
            del r, low, lsem, emb
            rows = [valid_rows(*decode.decode(stages, valid, logits, hw, sf,
                                              m, dt))
                    for dt in (torch.float32, torch.bfloat16)]
            worst('control', 'det_gap', det_gap(rows[1], rows[0]))
    return out
