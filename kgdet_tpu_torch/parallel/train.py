"""Training step, optimizer and LR schedule.

Port of kgdet_tpu/parallel/train.py: ``make_lr_schedule``,
``frozen_param_mask``, ``paramwise_multipliers``, ``make_optimizer``,
``build_level_geometry``, ``batch_valid_flags``, ``compute_loss``,
``make_loss_fn`` (the single-stage families through their registry, the
two-stage detectors through core/two_stage_loss.py on the RPN's anchor
valid flags) and ``make_train_step``. Parameters are addressed by their
``named_parameters()`` names (the reference's torch names). The step updates
the model in place and returns the logs. In a process group it is the
data-parallel step of parallel/dist.py, which holds the counterparts of the
JAX module's ``make_mesh``, ``shard_batch`` and ``replicate``.
"""
from __future__ import annotations

import re
from typing import Dict

import torch

from kgdet_tpu_torch.config import KGDetConfig
from kgdet_tpu_torch.ops.image import device_normalize
from kgdet_tpu_torch.ops.points import grid_points, valid_flags
from kgdet_tpu_torch.parallel.dist import all_reduce_grads, global_sum, world
from kgdet_tpu_torch.utils.trace import span


# --------------------------------------------------------------- LR schedule
def make_lr_schedule(cfg, steps_per_epoch: int):
    """mmcv-style linear warmup + step decay at epoch boundaries: warmup
    over ``warmup_iters`` from ``lr * warmup_ratio``, then
    ``lr * gamma ** (number of boundaries passed)``. schedule(step) is a
    Python float."""
    o = cfg.optim
    boundaries = [e * steps_per_epoch for e in o.lr_step_epochs]

    def schedule(step: int) -> float:
        base = o.lr * o.lr_step_gamma ** sum(step >= b for b in boundaries)
        if step >= o.warmup_iters:
            return base
        frac = min(max(step / max(o.warmup_iters, 1), 0.0), 1.0)
        return base * (1 - (1 - frac) * (1 - o.warmup_ratio))

    return schedule


# ------------------------------------------------------------- frozen params
def frozen_param_mask(model, frozen_stages: int) -> Dict[str, bool]:
    """{parameter name: True} for parameters that must NOT be updated (stem
    + stages <= frozen). Parity: ResNet._freeze_stages of the reference."""
    prefixes = []
    if frozen_stages >= 0:
        prefixes += ['backbone.conv1.', 'backbone.bn1.']
    prefixes += [f'backbone.layer{s}.' for s in range(1, frozen_stages + 1)]
    return {name: name.startswith(tuple(prefixes))
            for name, _ in model.named_parameters()}


def paramwise_multipliers(model, o):
    """({name: lr_mult}, {name: decay_mult}) from mmcv-style paramwise
    options: parameters under a norm module (a name component bn*/gn*) get
    ``norm_decay_mult`` on weight decay; other biases get ``bias_lr_mult``
    on the LR and ``bias_decay_mult`` on weight decay."""
    lr_mult, decay_mult = {}, {}
    for name, _ in model.named_parameters():
        parts = name.split('.')
        if any(re.fullmatch(r'(bn|gn)\d*', p) for p in parts[:-1]):
            lr_mult[name], decay_mult[name] = 1.0, o.norm_decay_mult
        elif parts[-1] == 'bias':
            lr_mult[name], decay_mult[name] = o.bias_lr_mult, \
                o.bias_decay_mult
        else:
            lr_mult[name], decay_mult[name] = 1.0, 1.0
    return lr_mult, decay_mult


# optax.scale_by_adam's defaults, which the JAX package takes as they are
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class SGDOptimizer:
    """SGD with momentum, or Adam (``cfg.optim.type``), in the order of the
    JAX package's optax chain: clip the global gradient norm; add
    ``weight_decay * decay_mult * p`` to the gradient (L2 folded into the
    gradient before the moments, as torch.optim does, not decoupled); then
    for ``sgd`` the momentum trace (no Nesterov, no dampening), for ``adam``
    the two moments with bias correction (``optax.scale_by_adam``:
    m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps)); scale by the scheduled LR
    and the parameter's LR multiplier; frozen parameters get no update.
    Gradients that are ``None`` count as zero, so a parameter the loss does
    not reach still decays, as under ``jax.grad``.

    ``step()`` reads ``p.grad``, updates the parameters in place and
    returns the gradient norm before clipping (a 0-d tensor)."""

    def __init__(self, model, cfg: KGDetConfig, steps_per_epoch: int):
        o = cfg.optim
        if o.type not in ('sgd', 'adam'):
            raise ValueError(f'unknown optimizer type: {o.type}')
        self.o = o
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        frozen = frozen_param_mask(model, cfg.backbone.frozen_stages)
        lr_mult, decay_mult = paramwise_multipliers(model, o)
        named = list(model.named_parameters())
        self.all_params = [p for _, p in named]
        self.names = [n for n, _ in named if not frozen[n]]
        self.params = [p for n, p in named if not frozen[n]]
        self.lr_mult = [lr_mult[n] for n, _ in named if not frozen[n]]
        self.decay = [o.weight_decay * decay_mult[n]
                      for n, _ in named if not frozen[n]]
        # sgd: the momentum trace; adam: the first moment
        self.momentum = [torch.zeros_like(p) for p in self.params]
        self.second_moment = [torch.zeros_like(p) for p in self.params] \
            if o.type == 'adam' else None
        self.step_count = 0

    @torch.no_grad()
    def step(self):
        o = self.o
        grads = [p.grad for p in self.all_params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        # optax.clip_by_global_norm: g * max_norm / max(norm, max_norm)
        scale = o.grad_clip_norm / torch.clamp(norm, min=o.grad_clip_norm)
        lr = self.schedule(self.step_count)
        t = self.step_count + 1
        for i, (p, buf, mult, decay) in enumerate(zip(
                self.params, self.momentum, self.lr_mult, self.decay)):
            g = p * decay if p.grad is None else p.grad * scale + p * decay
            if o.type == 'sgd':
                buf.mul_(o.momentum).add_(g)
                p.add_(buf, alpha=-lr * mult)
                continue
            nu = self.second_moment[i]
            buf.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
            denom = (nu / (1 - ADAM_B2 ** t)).sqrt_().add_(ADAM_EPS)
            p.addcdiv_(buf, denom, value=-lr * mult / (1 - ADAM_B1 ** t))
        self.step_count += 1
        return norm

    def zero_grad(self):
        for p in self.all_params:
            p.grad = None

    def state_dict(self):
        """The optimizer's state: its type, ``step_count`` (the LR is
        ``schedule(step_count)``) and its buffers keyed by parameter name
        (the free parameters only; ``second_moment`` under ``adam``).
        The buffers are the live tensors, as torch.optim's state_dict
        gives them."""
        state = {'type': self.o.type, 'step_count': self.step_count,
                 'momentum': dict(zip(self.names, self.momentum))}
        if self.second_moment is not None:
            state['second_moment'] = dict(zip(self.names,
                                              self.second_moment))
        return state

    @torch.no_grad()
    def load_state_dict(self, state):
        """Copy a state_dict's buffers into this optimizer's (any device
        to this one's) and take its ``step_count``: the next step is then
        the one the saved optimizer would have taken."""
        if state['type'] != self.o.type:
            raise ValueError(f'a {state["type"]} optimizer state does not '
                             f'load into a {self.o.type} optimizer')
        keys = [('momentum', self.momentum)]
        if self.second_moment is not None:
            keys.append(('second_moment', self.second_moment))
        for key, bufs in keys:
            saved = state[key]
            if sorted(saved) != sorted(self.names):
                missing = sorted(set(self.names) - set(saved))
                extra = sorted(set(saved) - set(self.names))
                raise KeyError(f'optimizer {key}: missing {missing[:4]}, '
                               f'unexpected {extra[:4]}')
            for name, buf in zip(self.names, bufs):
                if saved[name].shape != buf.shape:
                    raise ValueError(
                        f'optimizer {key} {name}: shape '
                        f'{tuple(saved[name].shape)} != {tuple(buf.shape)}')
                buf.copy_(saved[name])
        self.step_count = int(state['step_count'])


def make_optimizer(cfg: KGDetConfig, model, steps_per_epoch: int):
    """SGD + momentum (or Adam) + wd 1e-4 + global-norm clip 35 +
    warmup/step LR. Returns (optimizer, schedule)."""
    opt = SGDOptimizer(model, cfg, steps_per_epoch)
    return opt, opt.schedule


# ------------------------------------------------------------------ targets
def build_level_geometry(cfg: KGDetConfig, canvas_hw, device=None):
    """Static per-level (H*W, 3) grids for a padded canvas."""
    H, W = canvas_hw
    return [grid_points(-(-H // s), -(-W // s), s, device=device)
            for s in cfg.head.point_strides]


def batch_valid_flags(cfg: KGDetConfig, canvas_hw, valid_hw):
    """(B, P) per-level valid masks from per-image padded extents
    (pixels)."""
    H, W = canvas_hw
    outs = []
    for stride in cfg.head.point_strides:
        fh, fw = -(-H // stride), -(-W // stride)
        vh = torch.ceil(valid_hw[:, 0] / stride).to(torch.int32)
        vw = torch.ceil(valid_hw[:, 1] / stride).to(torch.int32)
        outs.append(valid_flags(fh, fw, vh, vw))
    return outs


# --------------------------------------------------------------- train step
def compute_loss(outs, grids, valids, batch, cfg: KGDetConfig,
                 canvas_hw=None):
    """Dispatch target building + loss through the head-family registry."""
    from kgdet_tpu_torch.models.families import get_head_family
    return get_head_family(cfg.head.type).loss(
        outs, grids, valids, batch, cfg, canvas_hw)


BATCH_KEYS = ('image', 'valid_hw', 'gt_bboxes', 'gt_labels', 'gt_kpts',
              'gt_mask')
# crowd regions, read by the refine assigner of the serial family and the
# two-stage assigners when the batch has them; Fast R-CNN's precomputed
# proposals; the mask families' ground-truth mask rasters and HTC's stuff
# maps
OPTIONAL_BATCH_KEYS = ('gt_bboxes_ignore', 'gt_ignore_mask', 'proposals',
                       'proposals_valid', 'gt_masks', 'gt_semantic_seg')


def two_stage_valid_flags(cfg: KGDetConfig, valid_hw, sizes):
    """(B, H_l * W_l * A) per-level anchor validity of the RPN from padded
    extents (pixels), on the levels' (H_l, W_l) ``sizes`` as the neck made
    them. The JAX package takes ceil(canvas / stride) instead, the same
    except where HRFPN pools a level down with floor division (800 / 64):
    there its flags do not match its anchors and its HRNet configs raise
    in the train step."""
    from kgdet_tpu_torch.ops.anchors import anchor_valid_flags
    A = len(cfg.head.anchor_scales) * len(cfg.head.anchor_ratios)
    outs = []
    for (fh, fw), stride in zip(sizes, cfg.head.point_strides):
        vh = torch.ceil(valid_hw[:, 0] / stride).to(torch.int32)
        vw = torch.ceil(valid_hw[:, 1] / stride).to(torch.int32)
        outs.append(anchor_valid_flags(fh, fw, A, vh, vw))
    return outs


def make_loss_fn(model, cfg: KGDetConfig, canvas_hw):
    """loss_fn(batch) -> (total, logs) on the model's device, with autograd
    recording. batch: image (B, H, W, 3) uint8 BGR or normalized float,
    valid_hw (B, 2), gt_bboxes (B, G, 4), gt_labels (B, G), gt_kpts
    (B, G, K, 3), gt_mask (B, G) and, optionally, gt_bboxes_ignore
    (B, Gi, 4) with gt_ignore_mask (B, Gi); tensors or numpy arrays.
    BatchNorm stays frozen, as in the JAX train step.

    The two-stage detectors (models/families.py::is_two_stage) also read
    the batch's scalar ``seed`` (0 where absent, as in the JAX package),
    which seeds their samplers (core/two_stage_loss.py::sampler_draw), and
    Fast R-CNN its ``proposals`` (B, R, 4) with ``proposals_valid``; the
    mask families ``gt_masks`` (B, G, H / mask_stride, W / mask_stride)
    and HTC ``gt_semantic_seg`` (B, H / seg_stride, W / seg_stride)."""
    from kgdet_tpu_torch.models.families import is_two_stage
    two_stage = is_two_stage(cfg.detector_type)
    if two_stage:
        from kgdet_tpu_torch.core.two_stage_loss import sampler_draw, \
            two_stage_loss_fn
        loss = two_stage_loss_fn(cfg.detector_type)
    grids = {}

    def loss_fn(batch):
        dev = next(model.parameters()).device
        feed = {k: torch.as_tensor(batch[k]).to(dev) for k in BATCH_KEYS
                + tuple(k for k in OPTIONAL_BATCH_KEYS if k in batch)}
        image = device_normalize(feed['image'], feed['valid_hw'])
        if two_stage:
            kw = {k: feed[k] for k in ('proposals', 'proposals_valid')
                  if k in feed}
            with span('forward'):
                fwd = model(image, feed['valid_hw'].float(), train=True,
                            **kw)
            with span('loss'):
                # Fast R-CNN has no RPN and reads no anchor flags
                valids = two_stage_valid_flags(
                    cfg, feed['valid_hw'],
                    [o['cls'].shape[2:4] for o in fwd['rpn_outs']]) \
                    if fwd['rpn_outs'] else None
                draw = sampler_draw(int(batch.get('seed', 0)), len(image),
                                    dev)
                return loss(fwd, feed, draw, cfg, valids,
                            canvas_hw=tuple(canvas_hw))
        if dev not in grids:
            grids[dev] = build_level_geometry(cfg, canvas_hw, device=dev)
        with span('forward'):
            outs = model(image)
        with span('loss'):
            valids = batch_valid_flags(cfg, canvas_hw, feed['valid_hw'])
            return compute_loss(outs, grids[dev], valids, feed, cfg,
                                canvas_hw=canvas_hw)

    return loss_fn


def make_train_step(model, cfg: KGDetConfig, canvas_hw, optimizer):
    """train_step(batch) -> logs: forward, loss, backward, one optimizer
    update in place. ``logs`` holds the family's loss terms and positive
    counts (nine terms and ``num_pos`` for the KGDet cascade; five terms a
    level, ``num_pos_init`` and ``num_pos_refine`` for the serial family),
    ``loss`` and ``grad_norm`` (the global norm before clipping) as detached
    0-d tensors on the model's device.

    In a process group the step takes this process's share of the global
    batch; it sums the gradients over the processes before the update and
    the loss terms before it returns them, so that the update and the logs
    are those of one process on the global batch (``num_pos*`` are summed
    inside the loss already).
    """
    loss_fn = make_loss_fn(model, cfg, canvas_hw)

    def train_step(batch):
        with span('step'):
            optimizer.zero_grad()
            total, logs = loss_fn(batch)
            with span('backward'):
                total.backward()
            logs = {k: v.detach() for k, v in logs.items()}
            logs['loss'] = total.detach()
            if world()[1] > 1:
                all_reduce_grads(optimizer.all_params)
                terms = [k for k in logs if not k.startswith('num_pos')]
                summed = global_sum(torch.stack([logs[k] for k in terms]))
                logs.update(zip(terms, summed.unbind()))
            with span('optimizer'):
                logs['grad_norm'] = optimizer.step()
            return logs

    return train_step

