"""Two-stage training losses (RPN + RCNN) and inference decoding.

Port of kgdet_tpu/core/two_stage_loss.py for the box-only detectors, with
the batch dimension written out where the JAX package uses ``vmap``. The
RPN: MaxIoU(0.7 / 0.3, min 0.3) over the concatenated anchor set, 256
anchors sampled at a positive fraction of 0.5, binary cross entropy and
smooth-L1 (beta 1/9) deltas. The RCNN stage: MaxIoU(0.5 / 0.5) over the
proposals, 512 sampled at 0.25, softmax cross entropy, smooth-L1 on the
labelled class's deltas (target stds 0.1 / 0.1 / 0.2 / 0.2), top-1 accuracy.
Cascade R-CNN runs three RCNN stages with rising IoU, tightening stds and
decaying weights. The mask families add: Mask R-CNN's per-pixel BCE on
each positive RoI's own-class mask against its ground truth cropped by
mask_head.py::mask_targets; Mask Scoring R-CNN's MSE (weight 0.5) of the
assigned class's mask IoU; Grid R-CNN's heatmap BCE on its leading RoIs
(MaxIoU 0.5, no sampling); HTC's semantic cross entropy and its per-stage
mask losses on its leading RoIs, weighted as the stages. GA-RPN replaces
the RPN terms with core/ga_loss.py::ga_rpn_loss. Decodes: the per-class
softmax and NMS over the padded proposals (Faster and Fast R-CNN; Mask
R-CNN's refined boxes, each detection carrying its mask probabilities and,
for Mask Scoring R-CNN, its rescored mask score), the stage-averaged
scores on the last stage's boxes (cascade), HTC's top boxes with their
stage-averaged masks, the grid-refined boxes, and the score-ranked
proposals (RPN), every image of the batch in one call.

The samplers draw a fixed quota per role (top-k over random priorities),
as the JAX package's do, so sample counts are static; the loss divides by
the realized count. They take their uniforms as tensors: selection is
split from the draw. ``sampler_draw`` draws them from a ``torch.Generator``
on the loss's device, seeded by the step's seed, the role (the RPN or a
RCNN stage) and each image's index in the global batch, so that one process
and several data-parallel processes pick the same samples. The JAX package
draws with ``jax.random`` (threefry), which this does not reproduce: the
samples differ from the JAX package's for the same seed (ROADMAP Queue 3);
given JAX's uniforms, the masks are the same.

In a process group the average factors (sampled counts, positive RoIs,
valid stuff pixels) are summed over the processes, as in
core/anchor_loss.py. Every term is computed in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from kgdet_tpu_torch.core.anchor_loss import clamp_to_image
from kgdet_tpu_torch.core.bbox_transforms import bbox2delta, delta2bbox
from kgdet_tpu_torch.core.iou_assign import assign_max_iou
from kgdet_tpu_torch.ops.losses import smooth_l1_loss
from kgdet_tpu_torch.ops.nms import multiclass_nms_kp
from kgdet_tpu_torch.parallel.dist import global_sum, world

RCNN_TARGET_STDS = (0.1, 0.1, 0.2, 0.2)

# Cascade R-CNN stage schedule (reference configs/cascade_rcnn_r50_fpn_1x:
# rising assignment IoU, tightening delta stds, decaying stage loss weight)
CASCADE_STAGE_IOUS = (0.5, 0.6, 0.7)
CASCADE_STAGE_STDS = ((0.1, 0.1, 0.2, 0.2),
                      (0.05, 0.05, 0.1, 0.1),
                      (0.033, 0.033, 0.067, 0.067))
CASCADE_STAGE_WEIGHTS = (1.0, 0.5, 0.25)


# ---------------------------------------------------------------- samplers
def random_quota_mask(u, mask, quota):
    """Up to ``quota`` True entries of ``mask`` (..., P), those of the
    largest uniforms ``u`` (..., P)."""
    if quota >= mask.shape[-1]:
        return mask
    pri = torch.where(mask, u, torch.full_like(u, -1.0))
    thresh = torch.topk(pri, quota, dim=-1).values[..., -1:]
    return mask & (pri >= thresh.clamp(min=0.0))


def balanced_quota_mask(u1, u2, mask, group_id, quota):
    """Up to ``quota`` True entries of ``mask`` (..., P), spread evenly over
    the groups ``group_id``: candidates get a random rank within their
    group (order by group, then ``u1``) and the globally smallest ranks win
    (ties broken by ``u2``), so small groups are taken whole and the rest
    tops up from larger ones: the fixed-shape form of the reference's
    IoU-balanced and instance-balanced samplers. The sort is stable and the
    group starts run through a cumulative max, as the JAX package's argsort
    and associative scan."""
    P = mask.shape[-1]
    if quota >= P:
        return mask
    inf = torch.full_like(u1, float('inf'))
    sort_key = torch.where(mask, group_id.float() * 2.0 + u1, inf)
    order = torch.sort(sort_key, dim=-1, stable=True)[1]
    idx = torch.arange(P, device=mask.device).expand_as(order)
    sorted_groups = torch.where(mask.gather(-1, order),
                                group_id.gather(-1, order), -1)
    is_start = torch.ones_like(mask)
    is_start[..., 1:] = sorted_groups[..., 1:] != sorted_groups[..., :-1]
    start_pos = torch.cummax(torch.where(is_start, idx, 0), dim=-1)[0]
    rank = torch.empty_like(order).scatter_(-1, order, idx - start_pos)
    key = torch.where(mask, rank + u2 * 0.99, inf)
    thresh = torch.topk(key, quota, dim=-1, largest=False).values[..., -1:]
    return mask & (key <= thresh)


def sample_pos_neg(u, pos_mask, neg_mask, num, pos_fraction,
                   neg_priority=None, pos_group_id=None, neg_group_id=None):
    """Positive and negative subsampling with static quotas.

    u: (..., 4, P) uniforms, in this order: the positives' priority (or,
    balanced, their in-group order), the positives' balanced tie-break, the
    negatives' two likewise. neg_priority (..., P): negatives taken by
    descending priority instead (OHEM: hard negatives by background
    cross entropy). pos_group_id / neg_group_id (..., P): that role sampled
    group-balanced (instance-balanced positives, IoU-balanced negatives)."""
    num_pos = int(num * pos_fraction)
    num_neg = num - num_pos
    if pos_group_id is not None:
        pos_sel = balanced_quota_mask(u[..., 0, :], u[..., 1, :], pos_mask,
                                      pos_group_id, num_pos)
    else:
        pos_sel = random_quota_mask(u[..., 0, :], pos_mask, num_pos)
    if neg_group_id is not None:
        neg_sel = balanced_quota_mask(u[..., 2, :], u[..., 3, :], neg_mask,
                                      neg_group_id, num_neg)
    elif neg_priority is None:
        neg_sel = random_quota_mask(u[..., 2, :], neg_mask, num_neg)
    elif num_neg < neg_mask.shape[-1]:
        pri = torch.where(neg_mask, neg_priority,
                          torch.full_like(neg_priority, float('-inf')))
        thresh = torch.topk(pri, num_neg, dim=-1).values[..., -1:]
        neg_sel = neg_mask & (pri >= thresh)
    else:
        neg_sel = neg_mask
    return pos_sel, neg_sel


# the sampler roles: the RPN, then each RCNN stage
RPN_ROLE = 0


def rcnn_role(stage: int = 0) -> int:
    return 1 + stage


def sampler_draw(seed, batch_size: int, device):
    """draw(role, n) -> (B, 4, n) uniforms for ``sample_pos_neg``: image i
    of this process's share draws from a torch.Generator on ``device``
    seeded by (seed, role, its index in the global batch). The processes of
    a group hold consecutive slices of the global batch (parallel/dist.py::
    shard_batch)."""
    first = world()[0] * batch_size
    seed = int(seed)

    def draw(role, n):
        out = []
        for i in range(first, first + batch_size):
            gen = torch.Generator(device=device)
            gen.manual_seed((seed * 1000003 + role * 7919 + i) % 2 ** 63)
            out.append(torch.rand((4, n), generator=gen, device=device))
        return torch.stack(out)
    return draw


# ------------------------------------------------------------------ losses
def bce_loss(logits, targets, weights, avg_factor):
    bce = logits.clamp(min=0) - logits * targets + torch.log1p(
        torch.exp(-logits.abs()))
    return (bce * weights).sum() / torch.clamp(avg_factor, min=1.0)


def _ignore(batch):
    return batch.get('gt_bboxes_ignore'), batch.get('gt_ignore_mask')


def _take(t, idx):
    """t (B, G, ...) at idx (B, P) -> (B, P, ...)."""
    return t.gather(1, idx.reshape(*idx.shape, *([1] * (t.dim() - 2)))
                    .expand(*idx.shape, *t.shape[2:]))


def rpn_loss(rpn_outs, anchors_per_level, valids_per_level, batch, u,
             num_samples=256, pos_fraction=0.5, pos_iou_thr=0.7,
             neg_iou_thr=0.3, min_pos_iou=0.3, ignore_iof_thr=-1.0):
    """Binary objectness + box regression over subsampled anchors. u:
    (B, 4, P) sampler uniforms. Returns (loss_cls, loss_bbox)."""
    valid = torch.cat(list(valids_per_level), dim=1)
    B = valid.shape[0]
    anchors = torch.cat(list(anchors_per_level), dim=0).expand(B, -1, 4)
    cls = torch.cat([o['cls'][-1].float().reshape(B, -1) for o in rpn_outs],
                    dim=1)
    reg = torch.cat([o['bbox'][-1].float().reshape(B, -1, 4)
                     for o in rpn_outs], dim=1)
    ign, ign_mask = _ignore(batch)
    gts = batch['gt_bboxes'].float()
    a = assign_max_iou(anchors, valid, gts, batch['gt_mask'], pos_iou_thr,
                       neg_iou_thr, min_pos_iou, gt_bboxes_ignore=ign,
                       gt_ignore_mask=ign_mask,
                       ignore_iof_thr=ignore_iof_thr)
    neg = valid & ~a.pos_mask & ~a.ignore_mask
    pos_sel, neg_sel = sample_pos_neg(u, a.pos_mask, neg, num_samples,
                                      pos_fraction)
    cls_w = (pos_sel | neg_sel).float()
    deltas = bbox2delta(anchors, _take(gts, a.assigned_gt))
    avg = global_sum(cls_w.sum())
    l_cls = bce_loss(cls, pos_sel.float(), cls_w, avg)
    l_reg = smooth_l1_loss(reg, deltas, pos_sel.float()[..., None],
                           beta=1.0 / 9.0, avg_factor=avg.clamp(min=1.0))
    return l_cls, l_reg


def rcnn_targets_and_loss(proposals, prop_valid, roi_cls, roi_reg, batch, u,
                          num_classes, num_samples=512, pos_fraction=0.25,
                          pos_iou_thr=0.5, neg_iou_thr=0.5,
                          sampler='random', ignore_iof_thr=-1.0,
                          target_stds=RCNN_TARGET_STDS):
    """RCNN stage: assign the proposals (B, R, 4), subsample, CE +
    smooth-L1 on the labelled class's deltas. u: (B, 4, R) sampler
    uniforms. sampler: 'random' | 'ohem' (hard negatives by background
    cross entropy) | 'instance_balanced' | 'iou_balanced'. Returns
    (loss_cls, loss_bbox, aux) with aux labels, pos_weights, assigned_gt
    and acc (top-1 over the sampled RoIs, in percent)."""
    B, R = proposals.shape[:2]
    roi_cls = roi_cls.float()
    roi_reg = roi_reg.float().reshape(B, R, -1, 4)
    ign, ign_mask = _ignore(batch)
    gts = batch['gt_bboxes'].float()
    a = assign_max_iou(proposals, prop_valid, gts, batch['gt_mask'],
                       pos_iou_thr, neg_iou_thr, 0.0, gt_bboxes_ignore=ign,
                       gt_ignore_mask=ign_mask,
                       ignore_iof_thr=ignore_iof_thr)
    neg = prop_valid & ~a.pos_mask & ~a.ignore_mask
    kw = {}
    if sampler == 'ohem':
        kw['neg_priority'] = -F.log_softmax(roi_cls.detach(), dim=-1)[..., 0]
    elif sampler == 'instance_balanced':
        kw['pos_group_id'] = a.assigned_gt
    elif sampler == 'iou_balanced':
        # 3 IoU bins over [0, neg_iou_thr) (iou_balanced_neg_sampler.py)
        kw['neg_group_id'] = (a.max_iou.clamp(min=0.0)
                              / max(neg_iou_thr, 1e-6) * 3) \
            .to(torch.int32).clamp(0, 2)
    elif sampler != 'random':
        raise ValueError(f'unknown rcnn sampler {sampler!r}')
    pos_sel, neg_sel = sample_pos_neg(u, a.pos_mask, neg, num_samples,
                                      pos_fraction, **kw)
    labels = torch.where(pos_sel, _take(batch['gt_labels'], a.assigned_gt),
                         0).long()
    cls_w = (pos_sel | neg_sel).float()
    deltas = bbox2delta(proposals, _take(gts, a.assigned_gt),
                        stds=target_stds)
    reg_w = pos_sel.float()
    avg = global_sum(cls_w.sum()).clamp(min=1.0)
    logp = F.log_softmax(roi_cls, dim=-1)
    l_cls = -(logp.gather(-1, labels[..., None])[..., 0] * cls_w).sum() / avg
    # the reference keeps a background slice at 0, so 1-based label c
    # indexes slice c
    cls_idx = labels.clamp(0, roi_reg.shape[2] - 1)
    reg_sel = roi_reg.gather(2, cls_idx[..., None, None].expand(B, R, 1, 4)
                             )[:, :, 0]
    l_reg = smooth_l1_loss(reg_sel, deltas, reg_w[..., None], beta=1.0,
                           avg_factor=avg)
    correct = (roi_cls.argmax(-1) == labels).float()
    acc = 100.0 * (correct * cls_w).sum() / avg
    aux = dict(labels=labels, pos_weights=reg_w, assigned_gt=a.assigned_gt,
               acc=acc)
    return l_cls, l_reg, aux


def _rpn_terms(fwd, batch, draw, cfg, valids_per_level, canvas_hw=None,
               ga=False):
    """The RPN's terms, or with ``ga`` GA-RPN's: (total, logs)."""
    if ga:
        from kgdet_tpu_torch.core.ga_loss import ga_rpn_loss
        n = sum(o['cls'].shape[2] * o['cls'].shape[3]
                for o in fwd['rpn_outs'])
        return ga_rpn_loss(fwd['rpn_outs'], batch, cfg.head,
                           cfg.refine_assigner or cfg.assigner,
                           canvas_hw or tuple(batch['image'].shape[1:3]),
                           draw(RPN_ROLE, n))
    n = sum(v.shape[1] for v in valids_per_level)
    l_cls, l_reg = rpn_loss(fwd['rpn_outs'], fwd['anchors'],
                            valids_per_level, batch, draw(RPN_ROLE, n),
                            ignore_iof_thr=cfg.assigner.ignore_iof_thr)
    return l_cls + l_reg, {'loss_rpn_cls': l_cls, 'loss_rpn_bbox': l_reg}


def _rcnn_terms(fwd, batch, draw, cfg, stage=0, **kw):
    return rcnn_targets_and_loss(
        fwd['proposals'], fwd['proposal_valid'], fwd['roi_cls'],
        fwd['roi_reg'], batch, draw(rcnn_role(stage),
                                    fwd['proposals'].shape[1]),
        cfg.head.num_classes, sampler=cfg.rcnn_sampler,
        ignore_iof_thr=cfg.assigner.ignore_iof_thr, **kw)


def _assign_leading(props, batch):
    """MaxIoU(0.5 / 0.5) of the leading RoIs (B, K, 4), all valid, no
    sampling (Grid R-CNN's and HTC's mask RoIs): (assigned GT, positive,
    1-based labels, 0 where not positive)."""
    with torch.no_grad():
        a = assign_max_iou(props, torch.ones(props.shape[:2], dtype=torch.bool,
                                             device=props.device),
                           batch['gt_bboxes'].float(), batch['gt_mask'],
                           0.5, 0.5, 0.0)
        labels = torch.where(a.pos_mask,
                             _take(batch['gt_labels'], a.assigned_gt), 0)
    return a.assigned_gt, a.pos_mask, labels.long()


def grid_terms(fwd, batch):
    """Grid R-CNN's heatmap loss on its leading RoIs."""
    from kgdet_tpu_torch.models.grid_head import grid_loss, grid_targets
    props = fwd['grid_props']
    assigned, pos, _ = _assign_leading(props, batch)
    gt_sel = _take(batch['gt_bboxes'].float(), assigned)
    with torch.no_grad():
        targets, valid_roi = grid_targets(props.reshape(-1, 4),
                                          gt_sel.reshape(-1, 4))
    wgt = (pos.reshape(-1) & valid_roi).float()
    return grid_loss(fwd['grid_fused'].flatten(0, 1),
                     fwd['grid_unfused'].flatten(0, 1), targets, wgt)


def mask_terms(fwd, batch, cfg, aux):
    """Mask R-CNN's mask loss on the sampled positives and, with a
    mask-IoU head, Mask Scoring R-CNN's IoU regression: a dict of terms."""
    from kgdet_tpu_torch.models.mask_head import _pick_class, mask_loss, \
        mask_targets, maskiou_targets
    logits = fwd['mask_logits']
    targets = mask_targets(batch['gt_masks'], aux['assigned_gt'],
                           fwd['proposals'], cfg.train_data.mask_stride,
                           out_size=logits.shape[2])
    pos_w = aux['pos_weights']
    out = {'loss_mask': mask_loss(logits, targets, aux['labels'], pos_w)}
    if 'maskiou_pred' in fwd:
        labels = aux['labels']
        iou_t = maskiou_targets(_pick_class(logits.detach(), labels),
                                targets)
        C = logits.shape[-1]
        pred = fwd['maskiou_pred'].float().gather(
            -1, (labels - 1).clamp(0, C - 1)[..., None])[..., 0]
        wgt = pos_w * (iou_t > 0)
        out['loss_mask_iou'] = 0.5 * ((pred - iou_t) ** 2 * wgt).sum() \
            / global_sum(wgt.sum()).clamp(min=1.0)
    return out


def faster_rcnn_loss(fwd, batch, draw, cfg, valids_per_level,
                     canvas_hw=None):
    """RPN (or GA-RPN) terms + RCNN terms, and the grid, mask and mask-IoU
    terms where the model has those heads (and the batch gt_masks):
    (total, logs)."""
    total, logs = _rpn_terms(fwd, batch, draw, cfg, valids_per_level,
                             canvas_hw, ga=cfg.rpn_type == 'ga_rpn')
    l_cls, l_reg, aux = _rcnn_terms(fwd, batch, draw, cfg)
    total = total + l_cls + l_reg
    logs.update(loss_cls=l_cls, loss_bbox=l_reg, acc=aux['acc'])
    extra = {}
    if 'grid_fused' in fwd:
        extra['loss_grid'] = grid_terms(fwd, batch)
    if 'mask_logits' in fwd and 'gt_masks' in batch:
        extra.update(mask_terms(fwd, batch, cfg, aux))
    for k, v in extra.items():
        total = total + v
        logs[k] = v
    return total, logs


def rpn_only_loss(fwd, batch, draw, cfg, valids_per_level, canvas_hw=None):
    """Standalone RPN (reference detectors/rpn.py forward_train): the RPN
    terms only."""
    return _rpn_terms(fwd, batch, draw, cfg, valids_per_level)


def fast_rcnn_loss(fwd, batch, draw, cfg, valids_per_level,
                   canvas_hw=None):
    """Fast R-CNN (reference detectors/fast_rcnn.py): the RCNN terms only;
    the proposals are inputs."""
    l_cls, l_reg, aux = _rcnn_terms(fwd, batch, draw, cfg)
    return l_cls + l_reg, {'loss_cls': l_cls, 'loss_bbox': l_reg,
                           'acc': aux['acc']}


def cascade_rcnn_loss(fwd, batch, draw, cfg, valids_per_level,
                      canvas_hw=None):
    """RPN terms + each stage's RCNN terms with the cascade's IoU / std /
    weight schedule (cascade_rcnn.py forward_train); HTC adds the semantic
    loss and each stage's mask loss on the leading RoIs, weighted as the
    stage."""
    total, logs = _rpn_terms(fwd, batch, draw, cfg, valids_per_level)
    if 'semantic_pred' in fwd and 'gt_semantic_seg' in batch:
        from kgdet_tpu_torch.models.mask_head import semantic_loss
        l_sem = semantic_loss(fwd['semantic_pred'], batch['gt_semantic_seg'])
        total = total + l_sem
        logs['loss_semantic_seg'] = l_sem
    for i, st in enumerate(fwd['stages']):
        iou = CASCADE_STAGE_IOUS[i]
        l_cls, l_reg, aux = _rcnn_terms(
            dict(st, proposal_valid=fwd['proposal_valid']), batch, draw,
            cfg, stage=i, pos_iou_thr=iou, neg_iou_thr=iou,
            target_stds=CASCADE_STAGE_STDS[i])
        total = total + CASCADE_STAGE_WEIGHTS[i] * (l_cls + l_reg)
        logs[f'loss_cls_s{i}'] = l_cls
        logs[f'loss_bbox_s{i}'] = l_reg
        logs[f'acc_s{i}'] = aux['acc']
    if 'mask_logits_stages' in fwd and 'gt_masks' in batch:
        from kgdet_tpu_torch.models.mask_head import mask_loss, mask_targets
        mprops = fwd['mask_props']
        assigned, pos, labels = _assign_leading(mprops, batch)
        stages = fwd['mask_logits_stages']
        targets = mask_targets(batch['gt_masks'], assigned, mprops,
                               cfg.train_data.mask_stride,
                               out_size=stages[0].shape[2])
        for i, logits in enumerate(stages):
            l_mask = mask_loss(logits, targets, labels, pos.float()) \
                * CASCADE_STAGE_WEIGHTS[i]
            total = total + l_mask
            logs[f'loss_mask_s{i}'] = l_mask
    return total, logs


LOSSES = {
    'faster_rcnn': faster_rcnn_loss,
    'mask_rcnn': faster_rcnn_loss,
    'ms_rcnn': faster_rcnn_loss,
    'double_head_rcnn': faster_rcnn_loss,
    'grid_rcnn': faster_rcnn_loss,
    'fast_rcnn': fast_rcnn_loss,
    'cascade_rcnn': cascade_rcnn_loss,
    'htc': cascade_rcnn_loss,
    'rpn': rpn_only_loss,
}


def two_stage_loss_fn(detector_type: str):
    """The loss entry of cfg.detector_type (the forward_train
    equivalents): fn(fwd, batch, draw, cfg, valids_per_level, canvas_hw)
    -> (total, logs), ``draw`` as ``sampler_draw`` returns it."""
    if detector_type not in LOSSES:
        raise KeyError(f'unknown two-stage detector {detector_type}')
    return LOSSES[detector_type]


# ------------------------------------------------------------------ decodes
def _nms(boxes, scores, scale_factor, test_cfg, src=None):
    """Rescale to the original images, multiclass NMS of every image at
    once: the padded detections with a width-3 dummy keypoint. ``src``
    (B, N, 1), where given, rides the NMS in the keypoint slot and comes
    back as ``det_src`` (each detection's row)."""
    boxes = boxes / scale_factor.float()[:, None, None]
    carry = boxes.new_zeros((*boxes.shape[:2], 3)) if src is None else src
    det_bboxes, det_labels, det_carry, valid = multiclass_nms_kp(
        boxes, scores, carry, test_cfg.score_thr, test_cfg.nms_iou_thr,
        max_per_class=test_cfg.max_per_class,
        max_per_img=test_cfg.max_per_img)
    out = {'det_bboxes': det_bboxes, 'det_labels': det_labels,
           'det_kpts': det_carry, 'valid': valid}
    if src is not None:
        out['det_kpts'] = det_bboxes.new_zeros((*det_labels.shape, 3))
        out['det_src'] = det_carry[..., 0].long().clamp(
            0, boxes.shape[1] - 1)
    return out


def _row_index(n, like):
    """(B, n, 1) row numbers, each row's source through the NMS."""
    return torch.arange(n, dtype=torch.float32, device=like.device)[
        None, :, None].expand(like.shape[0], n, 1)


def _det_masks(mask_logits, det_src, det_labels):
    """Each detection's mask probabilities: the sigmoid of its source
    row's logits (B, R, S, S, C) at its 0-based class -> (B, M, S, S)."""
    per_det = _take(mask_logits.float(), det_src)
    return torch.sigmoid(per_det.gather(-1, det_labels[
        ..., None, None, None].expand(*per_det.shape[:-1], 1))[..., 0])


def decode_rcnn_detections(fwd, img_hw, scale_factor, test_cfg,
                           num_classes):
    """Per-class softmax, each proposal's best-class box (NMS shares one
    box a proposal across classes, the fixed-shape form of the reference's
    per-class boxes; Mask R-CNN's forward has them as ``refined_boxes``),
    clamp, rescale, NMS. With mask logits each detection carries its
    mask probabilities (det_masks (B, M, S, S)) and, with a mask-IoU head,
    its mask score, the box score times the predicted IoU of its class
    clamped to [0, 1] (mask_scoring_rcnn.py's rescoring;
    det_mask_scores)."""
    proposals, valid = fwd['proposals'], fwd['proposal_valid']
    B, R = proposals.shape[:2]
    scores = F.softmax(fwd['roi_cls'].float(), dim=-1)
    fg_scores = torch.where(valid[..., None], scores[..., 1:], 0.0)
    if 'refined_boxes' in fwd:
        boxes = fwd['refined_boxes']
    else:
        reg = fwd['roi_reg'].float().reshape(B, R, -1, 4)
        best = fg_scores.argmax(-1)
        # slice 0 is background: foreground class c uses slice c + 1
        reg_best = reg.gather(2, (best + 1)[..., None, None].expand(
            B, R, 1, 4))[:, :, 0]
        boxes = delta2bbox(proposals.float(), reg_best,
                           stds=RCNN_TARGET_STDS)
    boxes = clamp_to_image(boxes, img_hw)
    if 'mask_logits' not in fwd:
        return _nms(boxes, fg_scores, scale_factor, test_cfg)
    out = _nms(boxes, fg_scores, scale_factor, test_cfg,
               src=_row_index(R, boxes))
    src, labels = out.pop('det_src'), out['det_labels']
    out['det_masks'] = _det_masks(fwd['mask_logits'], src, labels)
    if 'maskiou_pred' in fwd:
        iou = _take(fwd['maskiou_pred'].float(), src).gather(
            -1, labels[..., None])[..., 0]
        out['det_mask_scores'] = out['det_bboxes'][..., 4] \
            * iou.clamp(0.0, 1.0)
    return out


def decode_htc_detections(fwd, img_hw, scale_factor, test_cfg,
                          num_classes):
    """HTC: NMS over the top last-stage boxes with their stage-mean
    scores, each detection carrying its stage-averaged mask
    probabilities."""
    boxes = clamp_to_image(fwd['mask_boxes'], img_hw)
    scores = torch.where(fwd['mask_valid'][..., None], fwd['mask_scores'],
                         0.0)
    out = _nms(boxes, scores, scale_factor, test_cfg,
               src=_row_index(boxes.shape[1], boxes))
    src = out.pop('det_src')
    out['det_masks'] = _det_masks(fwd['mask_logits'], src,
                                  out['det_labels'])
    return out


def decode_grid_detections(fwd, img_hw, scale_factor, test_cfg,
                           num_classes):
    """Grid R-CNN: NMS over the grid-refined top boxes with their
    per-class scores (grid_rcnn.py simple_test order, fixed shapes)."""
    boxes = clamp_to_image(fwd['grid_boxes'], img_hw)
    scores = torch.where(fwd['grid_valid'][..., None], fwd['grid_scores'],
                         0.0)
    return _nms(boxes, scores, scale_factor, test_cfg)


def decode_cascade_detections(fwd, img_hw, scale_factor, test_cfg,
                              num_classes):
    """The last stage's class-agnostic boxes, the stages' softmax scores
    averaged (cascade_rcnn.py simple_test ms_scores), clamp, rescale,
    NMS."""
    stages, valid = fwd['stages'], fwd['proposal_valid']
    last = stages[-1]
    scores = sum(F.softmax(s['roi_cls'].float(), dim=-1)
                 for s in stages) / len(stages)
    fg_scores = torch.where(valid[..., None], scores[..., 1:], 0.0)
    boxes = delta2bbox(last['proposals'].float(), last['roi_reg'].float(),
                       stds=CASCADE_STAGE_STDS[len(stages) - 1])
    return _nms(clamp_to_image(boxes, img_hw), fg_scores, scale_factor,
                test_cfg)


def decode_rpn_proposals(fwd, img_hw, scale_factor, test_cfg, num_classes):
    """Standalone RPN (detectors/rpn.py simple_test): the proposals ranked
    by score (a stable sort, ties in index order), in original-image
    coordinates; the recall evaluation reads det_bboxes[..., :4] in rank
    order."""
    boxes = fwd['proposals'].float()
    scores = fwd['proposal_scores'].float()
    valid = fwd['proposal_valid']
    B, R = boxes.shape[:2]
    order = torch.sort(torch.where(valid, scores, float('-inf')), dim=-1,
                       descending=True, stable=True)[1]
    boxes = _take(boxes, order) / scale_factor.float()[:, None, None]
    det = torch.cat([boxes, scores.gather(1, order)[..., None]], dim=-1)
    return {'det_bboxes': det,
            'det_labels': torch.zeros((B, R), dtype=torch.long,
                                      device=boxes.device),
            'det_kpts': boxes.new_zeros((B, R, 3)),
            'valid': valid.gather(1, order)}
