"""Two-stage detectors: RPN head, RoI box heads, RPN, Faster / Fast R-CNN
with the mask, mask-IoU and grid branches (Mask R-CNN, Mask Scoring R-CNN,
Grid R-CNN), GA-RPN, and Cascade R-CNN with HTC's mask stages and
semantic branch.

Port of kgdet_tpu/models/two_stage.py.
Proposals are fixed-size padded tensors (per level a top-``nms_pre`` by a
stable descending sort, as jax.lax.top_k orders ties, then one greedy NMS
over the levels for every image at once, ops/nms.py) and are detached. RoI
features come from ops/roi.py::roi_align on each image's own map (no copy
of the map per RoI), through kernel K6 forward and K3 backward on the card.
Every level is gathered and each RoI's
scale-matched level is picked with ``where``, as the JAX package does.

Module and parameter names are the reference's (rpn_head.rpn_conv,
bbox_head.shared_fcs.0, bbox_head.<stage>.* for the cascade,
shared_head.layer4.<i>.* for C4), so a reference .pth loads as it is:
``shared_fcs.0`` and the double head's ``fc_branch.0`` flatten the RoI
features in the reference's (C, roi, roi) order. The heads compute in the
detector's dtype from f32 parameters; activations are NCHW into the heads,
NHWC into the RoI gather. The mask heads are models/mask_head.py, the grid
head models/grid_head.py, GA-RPN models/ga_head.py::GARPNHead with
core/ga_loss.py::ga_rpn_proposals; every RoI gather (boxes at 7x7, masks
and grids at 14x14, HTC's semantic RoIs) goes through ops/roi.py.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from kgdet_tpu_torch.core.anchor_loss import clamp_to_image
from kgdet_tpu_torch.core.bbox_transforms import delta2bbox
from kgdet_tpu_torch.core.two_stage_loss import CASCADE_STAGE_STDS, \
    RCNN_TARGET_STDS, _take
from kgdet_tpu_torch.models.layers import head_out, init_he_normal_, \
    init_normal_, init_variance_scaling_, init_xavier_uniform_
from kgdet_tpu_torch.models.resnet import ARCH_SETTINGS, Bottleneck, \
    ResNet
from kgdet_tpu_torch.ops.anchors import base_anchors, grid_anchors
from kgdet_tpu_torch.ops.nms import NEG_INF, greedy_nms
from kgdet_tpu_torch.ops.roi import roi_align
from kgdet_tpu_torch.utils.trace import span

# RoIs the Grid R-CNN and HTC heads take (the JAX modules' num_grid_* and
# num_mask_* fields, kgdet_tpu/models/two_stage.py:367-368 and :544-545):
# the leading proposals in training, the top best-class boxes at test.
NUM_HEAD_ROIS_TRAIN = 64
NUM_HEAD_ROIS_TEST = 128


def _linear(x, fc):
    return F.linear(x, fc.weight.to(x.dtype), fc.bias.to(x.dtype))


def _conv(x, conv, padding=0):
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), b, padding=padding)


def _group_norm(x, gn):
    return F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias,
                        gn.eps).to(x.dtype)


def _zero_biases(module):
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
            nn.init.zeros_(m.bias)


class RPNHead(nn.Module):
    """Class-agnostic region proposal head: a 3x3 conv, then 1x1 objectness
    and delta convs, on every level. Output per level: cls (1, B, H, W, A)
    and bbox (1, B, H, W, 4A), the JAX layout."""

    def __init__(self, in_channels=256, feat_channels=256, num_anchors=3):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def init_weights(self, gen):
        for conv in (self.rpn_conv, self.rpn_cls, self.rpn_reg):
            init_normal_(conv.weight, 0.01, gen)
        _zero_biases(self)

    def forward(self, feats):
        outs = []
        for x in feats:
            t = torch.relu(_conv(x, self.rpn_conv, padding=1))
            outs.append({'cls': head_out(t, self.rpn_cls),
                         'bbox': head_out(t, self.rpn_reg)})
        return outs


@torch.no_grad()
def rpn_proposals(rpn_outs, anchors_per_level, img_hw, nms_pre=1000,
                  max_num=1000, nms_thr=0.7, min_bbox_size=0.0):
    """Decode RPN outputs into fixed-size padded proposals: per level the
    top ``nms_pre`` anchors by objectness, decoded and clamped to the
    image, boxes not wider and taller than ``min_bbox_size`` dropped; then
    one greedy NMS over the levels, every image at once. Returns
    (proposals (B, max_num, 4), scores (B, max_num), valid (B, max_num))."""
    B = rpn_outs[0]['cls'].shape[1]
    lvl_boxes, lvl_scores = [], []
    for outs, anchors in zip(rpn_outs, anchors_per_level):
        P = anchors.shape[0]
        scores = torch.sigmoid(outs['cls'][-1].float().reshape(B, P))
        reg = outs['bbox'][-1].float().reshape(B, P, 4)
        k = min(nms_pre, P)
        top_scores, topk = torch.sort(scores, dim=-1, descending=True,
                                      stable=True)
        top_scores, topk = top_scores[:, :k], topk[:, :k]
        boxes = delta2bbox(anchors[topk], reg.gather(
            1, topk[..., None].expand(B, k, 4)))
        boxes = clamp_to_image(boxes, img_hw)
        ok = (boxes[..., 2] - boxes[..., 0] > min_bbox_size) \
            & (boxes[..., 3] - boxes[..., 1] > min_bbox_size)
        lvl_scores.append(torch.where(ok, top_scores, NEG_INF))
        lvl_boxes.append(boxes)
    return proposals_nms(torch.cat(lvl_boxes, dim=1),
                         torch.cat(lvl_scores, dim=1), nms_thr, max_num)


def proposals_nms(boxes, scores, nms_thr, max_num):
    """One greedy NMS of every image's candidates (B, N, 4) at once, kept
    boxes gathered and padded: (proposals (B, max_num, 4), scores, valid);
    a candidate scored NEG_INF is never kept."""
    B = boxes.shape[0]
    keep_idx, keep_scores = greedy_nms(boxes, scores, nms_thr, max_num)
    valid = keep_scores > NEG_INF / 2
    safe = keep_idx.clamp(0, boxes.shape[1] - 1)
    props = boxes.gather(1, safe[..., None].expand(B, max_num, 4))
    return (torch.where(valid[..., None], props, 0.0),
            torch.where(valid, keep_scores, 0.0), valid)


def map_rois_to_levels(rois_wh, num_levels, finest_scale=56):
    """The FPN level of each RoI by its sqrt-area (single_level.py
    map_roi_levels)."""
    scale = torch.sqrt(torch.clamp(rois_wh[..., 0] * rois_wh[..., 1],
                                   min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int32)


def extract_roi_feats(feats, strides, proposals, valid, out_size=7,
                      sample_num=2, finest_scale=56):
    """Multi-level RoIAlign: each RoI takes its scale-matched level.
    feats: (B, H_l, W_l, C) maps; proposals (B, R, 4) in image
    coordinates; valid (B, R). Returns (B, R, out, out, C), zero for an
    invalid RoI."""
    wh = torch.stack([proposals[..., 2] - proposals[..., 0],
                      proposals[..., 3] - proposals[..., 1]], dim=-1)
    lvl = map_rois_to_levels(wh, len(feats), finest_scale)
    out = None
    for li, (feat, stride) in enumerate(zip(feats, strides)):
        f = roi_align(feat, proposals, out_size=out_size,
                      spatial_scale=1.0 / stride, sample_num=sample_num)
        mask = ((lvl == li) & valid)[..., None, None, None]
        out = torch.where(mask, f, torch.zeros_like(f) if out is None
                          else out)
    return out


def _reg_dim(num_classes, agnostic):
    return 4 if agnostic else 4 * (num_classes + 1)


def _flat_roi(x):
    """(..., roi, roi, C) -> (..., C * roi * roi) in the reference's
    (C, roi, roi) order."""
    return x.movedim(-1, -3).flatten(-3)


class ConvFCBBoxHead(nn.Module):
    """Shared-2FC RoI box head: softmax cls (C + 1) and per-class deltas in
    the reference layout, (C + 1) slices with background at 0
    (convfc_bbox_head.py), or 4 class-agnostic deltas."""

    def __init__(self, num_classes=13, in_channels=256, fc_channels=1024,
                 roi_size=7, reg_class_agnostic=False):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_channels),
            nn.Linear(fc_channels, fc_channels)])
        self.fc_cls = nn.Linear(fc_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_channels,
                                _reg_dim(num_classes, reg_class_agnostic))

    def init_weights(self, gen):
        for fc in self.shared_fcs:
            init_xavier_uniform_(fc.weight, gen)
        init_normal_(self.fc_cls.weight, 0.01, gen)
        init_normal_(self.fc_reg.weight, 0.001, gen)
        _zero_biases(self)

    def forward(self, roi_feats):
        """(..., roi, roi, C) -> (cls (..., C + 1), deltas)."""
        x = _flat_roi(roi_feats)
        for fc in self.shared_fcs:
            x = torch.relu(_linear(x, fc))
        return _linear(x, self.fc_cls), _linear(x, self.fc_reg)


class _ConvGN(nn.Module):
    """conv + GroupNorm under the reference ConvModule's names (conv, gn);
    flax GroupNorm's epsilon, 1e-6."""

    def __init__(self, cin, cout, k, groups, bias=False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias)
        self.gn = nn.GroupNorm(groups, cout, eps=1e-6)

    def forward(self, x):
        return _group_norm(_conv(x, self.conv, self.conv.padding), self.gn)


class BasicResBlock(nn.Module):
    """The double head's 3x3 + 1x1 block with a 1x1 projection
    (double_bbox_head.py:10-70), GroupNorm for the reference's BatchNorm as
    in the JAX package."""

    def __init__(self, in_channels, out_channels, gn_groups=32):
        super().__init__()
        self.conv1 = _ConvGN(in_channels, in_channels, 3,
                             min(gn_groups, in_channels))
        self.conv2 = _ConvGN(in_channels, out_channels, 1, gn_groups)
        self.conv_identity = _ConvGN(in_channels, out_channels, 1, gn_groups,
                                     bias=True)

    def forward(self, x):
        h = self.conv2(torch.relu(self.conv1(x)))
        return torch.relu(h + self.conv_identity(x))


class ResBottleneckGN(nn.Module):
    """The double head's 1x1-3x3-1x1 conv-branch bottleneck, GroupNorm."""

    def __init__(self, channels, planes, gn_groups=32):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, planes, 1, bias=False)
        self.gn1 = nn.GroupNorm(min(gn_groups, planes), planes, eps=1e-6)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.gn2 = nn.GroupNorm(min(gn_groups, planes), planes, eps=1e-6)
        self.conv3 = nn.Conv2d(planes, channels, 1, bias=False)
        self.gn3 = nn.GroupNorm(gn_groups, channels, eps=1e-6)

    def forward(self, x):
        h = torch.relu(_group_norm(_conv(x, self.conv1), self.gn1))
        h = torch.relu(_group_norm(_conv(h, self.conv2, 1), self.gn2))
        return torch.relu(_group_norm(_conv(h, self.conv3), self.gn3) + x)


class DoubleConvFCBBoxHead(nn.Module):
    """Double-head RoI box head: a conv branch regresses, an fc branch
    classifies (double_bbox_head.py:73-180, detectors/double_head_rcnn.py).
    """

    def __init__(self, num_classes=13, in_channels=256, num_convs=4,
                 num_fcs=2, conv_out_channels=1024, fc_out_channels=1024,
                 roi_size=7, reg_class_agnostic=False):
        super().__init__()
        self.res_block = BasicResBlock(in_channels, conv_out_channels)
        self.conv_branch = nn.ModuleList(
            ResBottleneckGN(conv_out_channels, conv_out_channels // 4)
            for _ in range(num_convs))
        self.fc_branch = nn.ModuleList(
            nn.Linear(in_channels * roi_size * roi_size if i == 0
                      else fc_out_channels, fc_out_channels)
            for i in range(num_fcs))
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(conv_out_channels,
                                _reg_dim(num_classes, reg_class_agnostic))

    def init_weights(self, gen):
        """flax's defaults where the JAX head sets none: lecun normal
        convs, unit GroupNorm scales, zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_variance_scaling_(m.weight, gen)
        for fc in self.fc_branch:
            init_xavier_uniform_(fc.weight, gen)
        init_normal_(self.fc_cls.weight, 0.01, gen)
        init_normal_(self.fc_reg.weight, 0.001, gen)
        _zero_biases(self)

    def forward(self, roi_feats):
        lead = roi_feats.shape[:-3]
        x = roi_feats.reshape(-1, *roi_feats.shape[-3:])
        xc = self.res_block(x.permute(0, 3, 1, 2))
        for block in self.conv_branch:
            xc = block(xc)
        reg = _linear(xc.mean((2, 3)), self.fc_reg)
        xf = _flat_roi(x)
        for fc in self.fc_branch:
            xf = torch.relu(_linear(xf, fc))
        cls = _linear(xf, self.fc_cls)
        return cls.reshape(*lead, -1), reg.reshape(*lead, -1)


class SharedResLayer(nn.Module):
    """The C4 shared head: ResNet stage 4's bottlenecks over the RoI
    features (shared_heads/res_layer.py), FrozenBatchNorm, under the
    reference names shared_head.layer4.<i>.*; ``style='caffe'`` puts the
    stride on the first 1x1. (N, roi, roi, C) -> (N, C', roi / 2, roi / 2)
    NCHW."""

    def __init__(self, depth=50, stride=2, style='pytorch'):
        super().__init__()
        in_ch = ResNet.stage_channels(depth)[2]
        blocks = []
        for i in range(ARCH_SETTINGS[depth][1][3]):
            blocks.append(Bottleneck(in_ch, 512, stride if i == 0 else 1,
                                     downsample=i == 0, style=style))
            in_ch = 512 * Bottleneck.expansion
        self.layer4 = nn.Sequential(*blocks)

    def init_weights(self, gen):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_he_normal_(m.weight, gen)

    def forward(self, x):
        return self.layer4(x.permute(0, 3, 1, 2))


class AvgPoolBBoxHead(nn.Module):
    """Global average pool + fc_cls / fc_reg (bbox_head.py with
    with_avg_pool=True, no shared fcs). Takes NCHW."""

    def __init__(self, num_classes=13, in_channels=2048,
                 reg_class_agnostic=False):
        super().__init__()
        self.fc_cls = nn.Linear(in_channels, num_classes + 1)
        self.fc_reg = nn.Linear(in_channels,
                                _reg_dim(num_classes, reg_class_agnostic))

    def init_weights(self, gen):
        init_normal_(self.fc_cls.weight, 0.01, gen)
        init_normal_(self.fc_reg.weight, 0.001, gen)
        _zero_biases(self)

    def forward(self, x):
        x = x.mean((2, 3))
        return _linear(x, self.fc_cls), _linear(x, self.fc_reg)


# -------------------------------------------------------------- detectors
def _top_k_stable(scores, k):
    """Indices (B, k) of the k largest scores (B, R), ties in index order,
    as jax.lax.top_k orders them."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :k]


def best_class_boxes(proposals, roi_cls, roi_reg):
    """Each proposal refined by its best foreground class's deltas (the
    reference layout: slice c + 1 for foreground class c), target stds
    RCNN_TARGET_STDS. Returns (boxes (B, R, 4), fg scores (B, R, C))."""
    B, R = proposals.shape[:2]
    fg = F.softmax(roi_cls.float(), dim=-1)[..., 1:]
    best = fg.argmax(-1)
    reg = roi_reg.float().reshape(B, R, -1, 4)
    reg_best = reg.gather(2, (best + 1)[..., None, None].expand(B, R, 1, 4)
                          )[:, :, 0]
    return delta2bbox(proposals.float(), reg_best,
                      stds=RCNN_TARGET_STDS), fg


class TwoStageBase(nn.Module):
    """backbone -> neck -> (RPN, or GA-RPN where ``ga_rpn``): the parts
    every two-stage detector shares. forward returns the JAX module's
    dict."""

    def __init__(self, cfg, num_proposals_train=512, num_proposals_test=1000,
                 with_rpn=True, ga_rpn=False):
        from kgdet_tpu_torch.models.detector import build_backbone, \
            build_neck, compute_dtype
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.num_proposals_train = num_proposals_train
        self.num_proposals_test = num_proposals_test
        self.backbone = build_backbone(cfg.backbone)
        self.neck = build_neck(cfg.neck)
        h, c = cfg.head, cfg.neck.out_channels
        self.ga_rpn = with_rpn and ga_rpn
        if self.ga_rpn:
            from kgdet_tpu_torch.models.ga_head import GARPNHead
            self.rpn_head = GARPNHead(c, c)
        elif with_rpn:
            self.rpn_head = RPNHead(
                c, c, len(h.anchor_scales) * len(h.anchor_ratios))
        self._anchor_sets = {}      # the static anchors, once a shape

    def heads(self):
        return [m for n, m in self.named_children()
                if n not in ('backbone', 'neck')]

    def init_weights(self, seed: int = 0):
        """Seeded random weights, with the distributions of the JAX
        inits."""
        gen = torch.Generator().manual_seed(seed)
        for part in (self.backbone, self.neck, *self.heads()):
            if part is None:
                continue
            if isinstance(part, nn.ModuleList):
                for m in part:
                    m.init_weights(gen)
            else:
                part.init_weights(gen)
        return self

    def features(self, images):
        with span('backbone'):
            feats = self.backbone(images.to(self.dtype))
        if self.neck is None:
            return list(feats)
        with span('neck'):
            return list(self.neck(feats))

    def anchors(self, feats):
        h = self.cfg.head
        key = tuple((f.shape[2], f.shape[3], f.device) for f in feats)
        if key not in self._anchor_sets:
            self._anchor_sets[key] = [
                grid_anchors(base_anchors(s, list(h.anchor_scales),
                                          h.anchor_ratios),
                             f.shape[2], f.shape[3], s, device=f.device)
                for f, s in zip(feats, h.point_strides)]
        return self._anchor_sets[key]

    def ga_squares(self, canvas, device):
        """GA-RPN's square anchors of each level of ``canvas``, once a
        canvas and device."""
        from kgdet_tpu_torch.core.ga_loss import ga_squares
        h = self.cfg.head
        key = ('ga', tuple(canvas), device)
        if key not in self._anchor_sets:
            self._anchor_sets[key] = [
                ga_squares(s, h.octave_base_scale, -(-canvas[0] // s),
                           -(-canvas[1] // s), device=device)
                for s in h.point_strides]
        return self._anchor_sets[key]

    def propose(self, feats, img_hw, train, canvas=None):
        """The RPN's outputs and padded proposals; GA-RPN decodes on the
        levels of ``canvas`` (the images' padded (H, W))."""
        with span('rpn'):
            rpn_outs = self.rpn_head(feats)
        n = self.num_proposals_train if train else self.num_proposals_test
        with span('proposals'):
            if self.ga_rpn:
                from kgdet_tpu_torch.core.ga_loss import ga_rpn_proposals
                anchors = None
                proposals, scores, valid = ga_rpn_proposals(
                    rpn_outs, self.cfg.head, canvas, img_hw, max_num=n,
                    squares=self.ga_squares(canvas, img_hw.device))
            else:
                anchors = self.anchors(feats)
                proposals, scores, valid = rpn_proposals(rpn_outs, anchors,
                                                         img_hw, max_num=n)
        return dict(rpn_outs=rpn_outs, anchors=anchors, proposals=proposals,
                    proposal_scores=scores, proposal_valid=valid)

    def roi_feats(self, feats, proposals, valid, out_size=7):
        with span('roi_extract'):
            return extract_roi_feats(
                [f.permute(0, 2, 3, 1) for f in feats],
                self.cfg.head.point_strides, proposals, valid,
                out_size=out_size)

    @staticmethod
    def _img_hw(images, img_hw):
        if img_hw is not None:
            return img_hw.float()
        return images.new_tensor([[images.shape[1], images.shape[2]]],
                                 dtype=torch.float32).expand(
                                     images.shape[0], 2)


class RPNDetector(TwoStageBase):
    """Standalone RPN: backbone -> neck -> RPN head -> padded proposals
    (reference detectors/rpn.py; evaluated by recall)."""

    def forward(self, images, img_hw=None, train=True):
        return self.propose(self.features(images),
                            self._img_hw(images, img_hw), train,
                            canvas=images.shape[1:3])


class FasterRCNN(TwoStageBase):
    """backbone -> neck -> RPN or, with cfg.rpn_type 'ga_rpn', GA-RPN (or,
    Fast R-CNN, proposals as inputs) -> RoI box head: the ConvFC head, the
    double head (detector_type 'double_head_rcnn') or, with cfg.rcnn_head
    'res_layer' (C4), the shared layer4 and the average-pool head on 14x14
    RoIs.

    Mask R-CNN (with_mask) adds a mask head on 14x14 RoIs: every proposal
    in training, each proposal's best-class refined box at test (what the
    NMS consumes); Mask Scoring R-CNN (with_maskiou) the mask-IoU head on
    the best class's mask. Grid R-CNN (with_grid) trains the grid head on
    the leading ``NUM_HEAD_ROIS_TRAIN`` proposals and at test refines the
    top ``NUM_HEAD_ROIS_TEST`` best-class boxes by heatmap boundary voting
    before the NMS (the reference refines the NMS survivors; a fixed top-K
    keeps the shapes static, as in the JAX package)."""

    def __init__(self, cfg, external_proposals=False, **kw):
        super().__init__(cfg, with_rpn=not external_proposals,
                         ga_rpn=cfg.rpn_type == 'ga_rpn', **kw)
        self.external_proposals = external_proposals
        dt = cfg.detector_type
        self.with_mask = dt in ('mask_rcnn', 'ms_rcnn')
        self.with_maskiou = dt == 'ms_rcnn'
        self.with_grid = dt == 'grid_rcnn'
        h, c = cfg.head, cfg.neck.out_channels
        self.roi_size = 7
        if dt == 'double_head_rcnn':
            self.bbox_head = DoubleConvFCBBoxHead(h.num_classes, c)
        elif cfg.rcnn_head == 'res_layer':
            self.shared_head = SharedResLayer(cfg.backbone.depth,
                                              style=cfg.backbone.style)
            self.bbox_head = AvgPoolBBoxHead(h.num_classes)
            self.roi_size = 14
        else:
            self.bbox_head = ConvFCBBoxHead(h.num_classes, c)
        if self.with_grid:
            from kgdet_tpu_torch.models.grid_head import GridHead
            self.grid_head = GridHead(in_channels=c)
        if self.with_mask:
            from kgdet_tpu_torch.models.mask_head import FCNMaskHead
            self.mask_head = FCNMaskHead(h.num_classes, c)
        if self.with_maskiou:
            from kgdet_tpu_torch.models.mask_head import MaskIoUHead
            self.mask_iou_head = MaskIoUHead(h.num_classes, c)

    def box_head(self, roi_feats):
        with span('roi_head'):
            if not hasattr(self, 'shared_head'):
                return self.bbox_head(roi_feats)
            lead = roi_feats.shape[:-3]
            cls, reg = self.bbox_head(self.shared_head(
                roi_feats.reshape(-1, *roi_feats.shape[-3:])))
            return cls.reshape(*lead, -1), reg.reshape(*lead, -1)

    def forward(self, images, img_hw=None, train=True, proposals=None,
                proposals_valid=None):
        img_hw = self._img_hw(images, img_hw)
        feats = self.features(images)
        if self.external_proposals:
            if proposals is None:
                raise ValueError('fast_rcnn requires proposals inputs (set '
                                 'DataConfig.proposal_file)')
            valid = proposals_valid if proposals_valid is not None \
                else torch.ones(proposals.shape[:2], dtype=torch.bool,
                                device=proposals.device)
            out = dict(rpn_outs=None, anchors=None, proposals=proposals,
                       proposal_scores=valid.float(), proposal_valid=valid)
        else:
            out = self.propose(feats, img_hw, train,
                               canvas=images.shape[1:3])
        out['proposals'] = out['proposals'].float().detach()
        roi_feats = self.roi_feats(feats, out['proposals'],
                                   out['proposal_valid'], self.roi_size)
        out['roi_cls'], out['roi_reg'] = self.box_head(roi_feats)
        if self.with_grid:
            out.update(self.grid_forward(feats, out, train))
        if self.with_mask:
            out.update(self.mask_forward(feats, out, train))
        return out

    def grid_forward(self, feats, out, train):
        props, valid = out['proposals'], out['proposal_valid']
        B, R = props.shape[:2]
        if train:
            K = min(NUM_HEAD_ROIS_TRAIN, R)
            props = props[:, :K]
            g = self.roi_feats(feats, props, valid[:, :K], 14)
            fused, unfused = self.grid_head(g.flatten(0, 1), train=True)
            hm = fused.shape[1:]
            return dict(grid_fused=fused.reshape(B, K, *hm),
                        grid_unfused=unfused.reshape(B, K, *hm),
                        grid_props=props)
        from kgdet_tpu_torch.models.grid_head import grid_refine_boxes
        refined, fg = best_class_boxes(props, out['roi_cls'], out['roi_reg'])
        best = torch.where(valid, fg.amax(-1), -1.0)
        top = _top_k_stable(best, min(NUM_HEAD_ROIS_TEST, R))
        refined, valid_k = _take(refined, top), valid.gather(1, top)
        g = self.roi_feats(feats, refined.detach(), valid_k, 14)
        heat, _ = self.grid_head(g.flatten(0, 1), train=False)
        heat = heat.reshape(*top.shape, *heat.shape[1:])
        return dict(grid_boxes=grid_refine_boxes(heat, refined),
                    grid_scores=_take(fg, top), grid_valid=valid_k)

    def mask_forward(self, feats, out, train):
        props, valid = out['proposals'], out['proposal_valid']
        B, R = props.shape[:2]
        res = {}
        if train:
            boxes = props
        else:
            boxes, _ = best_class_boxes(props, out['roi_cls'],
                                        out['roi_reg'])
            res['refined_boxes'] = boxes
        mfeats = self.roi_feats(feats, boxes.detach(), valid, 14)
        logits = self.mask_head(mfeats.flatten(0, 1))
        res['mask_logits'] = logits.reshape(B, R, *logits.shape[1:])
        if self.with_maskiou:
            fg = F.softmax(out['roi_cls'].float(), dim=-1)[..., 1:]
            best = fg.argmax(-1)
            best_mask = res['mask_logits'].gather(-1, best[
                ..., None, None, None].expand(*res['mask_logits'].shape[:-1],
                                              1))[..., 0]
            res['maskiou_pred'] = self.mask_iou_head(mfeats, best_mask)
        return res


class CascadeRCNN(TwoStageBase):
    """Cascade R-CNN: a shared RPN and three ConvFC heads with
    class-agnostic deltas; each stage's deltas, decoded with its stds,
    clamped and detached, are the next stage's RoIs (cascade_rcnn.py).

    HTC (detector_type 'htc', htc.py) adds a mask head a stage with mask
    information flow (stage i > 0 adds a 1x1 transform of stage i - 1's
    pre-deconv features): in training on the leading
    ``NUM_HEAD_ROIS_TRAIN`` proposals, at test on the
    ``NUM_HEAD_ROIS_TEST`` best last-stage boxes by
    the stages' mean score, the stages' logits averaged. With
    cfg.with_semantic the semantic branch's embedding, RoI-aligned on its
    fusion level (the second), is added to the box and mask RoI
    features."""

    def __init__(self, cfg, num_stages=3, **kw):
        super().__init__(cfg, **kw)
        h, c = cfg.head, cfg.neck.out_channels
        self.bbox_head = nn.ModuleList(
            ConvFCBBoxHead(h.num_classes, c, reg_class_agnostic=True)
            for _ in range(num_stages))
        strides = h.point_strides
        self.sem_stride = strides[1] if len(strides) > 1 else strides[0]
        if cfg.with_semantic:
            from kgdet_tpu_torch.models.mask_head import FusedSemanticHead
            self.semantic_head = FusedSemanticHead(
                num_ins=len(strides), in_channels=c, conv_channels=c,
                num_classes=h.num_stuff_classes)
        if cfg.detector_type == 'htc':
            from kgdet_tpu_torch.models.mask_head import FCNMaskHead
            self.mask_head = nn.ModuleList(
                FCNMaskHead(h.num_classes, c, with_info_flow=i > 0)
                for i in range(num_stages))

    def add_semantic(self, roi_feats, sem_feat, rois, valid, out_size):
        """roi_feats + the semantic embedding (B, H, W, C) RoI-aligned at
        the fusion level's stride (htc.py:56-76), zero for an invalid
        RoI."""
        if sem_feat is None:
            return roi_feats
        s = roi_align(sem_feat, rois, out_size=out_size,
                      spatial_scale=1.0 / self.sem_stride, sample_num=2)
        return roi_feats + torch.where(valid[..., None, None, None], s,
                                       torch.zeros_like(s))

    def forward(self, images, img_hw=None, train=True):
        img_hw = self._img_hw(images, img_hw)
        feats = self.features(images)
        out = self.propose(feats, img_hw, train, canvas=images.shape[1:3])
        boxes, valid = out['proposals'], out['proposal_valid']
        sem = None
        if hasattr(self, 'semantic_head'):
            out['semantic_pred'], sem = self.semantic_head(feats)
        stages = []
        for i, head in enumerate(self.bbox_head):
            roi = self.add_semantic(self.roi_feats(feats, boxes, valid),
                                    sem, boxes, valid, 7)
            with span('roi_head'):
                roi_cls, roi_reg = head(roi)
            stages.append(dict(proposals=boxes, roi_cls=roi_cls,
                               roi_reg=roi_reg))
            if i < len(self.bbox_head) - 1:
                boxes = clamp_to_image(delta2bbox(
                    boxes, roi_reg.detach().float(),
                    stds=CASCADE_STAGE_STDS[i]), img_hw)
        out['stages'] = stages
        if hasattr(self, 'mask_head'):
            out.update(self.mask_forward(feats, sem, out, train))
        return out

    def mask_forward(self, feats, sem, out, train):
        props, valid = out['proposals'], out['proposal_valid']
        stages = out['stages']
        B, R = props.shape[:2]
        res = {}
        if train:
            K = min(NUM_HEAD_ROIS_TRAIN, R)
            mprops, mvalid = props[:, :K], valid[:, :K]
            res['mask_props'] = mprops
        else:
            scores = sum(F.softmax(s['roi_cls'].float(), dim=-1)
                         for s in stages) / len(stages)
            fg = torch.where(valid[..., None], scores[..., 1:], 0.0)
            last = stages[-1]
            dec = delta2bbox(last['proposals'].float(),
                             last['roi_reg'].float(),
                             stds=CASCADE_STAGE_STDS[len(stages) - 1])
            best = torch.where(valid, fg.amax(-1), -1.0)
            top = _top_k_stable(best, min(NUM_HEAD_ROIS_TEST, R))
            mprops, mvalid = _take(dec, top), valid.gather(1, top)
            res.update(mask_boxes=mprops, mask_scores=_take(fg, top),
                       mask_valid=mvalid)
        mprops = mprops.detach()
        mfeats = self.add_semantic(self.roi_feats(feats, mprops, mvalid, 14),
                                   sem, mprops, mvalid, 14)
        flat = mfeats.flatten(0, 1)
        feat, logits = None, []
        for head in self.mask_head:
            lg, feat = head(flat, res_feat=feat, return_feat=True)
            logits.append(lg.reshape(*mprops.shape[:2], *lg.shape[1:]))
        if train:
            res['mask_logits_stages'] = logits
        else:
            res['mask_logits'] = sum(lg.float() for lg in logits) \
                / len(logits)
        return res


def build_two_stage(cfg):
    """The detector of a two-stage ``cfg.detector_type``."""
    dt = cfg.detector_type
    kw = dict(num_proposals_train=cfg.num_proposals_train,
              num_proposals_test=cfg.num_proposals_test)
    if dt in ('cascade_rcnn', 'htc'):
        return CascadeRCNN(cfg, **kw)
    if dt == 'rpn':
        return RPNDetector(cfg, **kw)
    if dt in ('faster_rcnn', 'fast_rcnn', 'mask_rcnn', 'ms_rcnn',
              'double_head_rcnn', 'grid_rcnn'):
        return FasterRCNN(cfg, external_proposals=dt == 'fast_rcnn', **kw)
    raise KeyError(f'unknown two-stage detector {dt}')
