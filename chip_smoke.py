#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kgdet_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Setup: builds the hand-written kernels from kgdet_tpu_torch/csrc/ with nvcc
(sm_90a) and times the build.
Phase 1: each kernel (K1 deform_fused, K2 deform_sample_split, K3
deform_sample_bwd, K4 stem_pool, K5 frozen_bottleneck, K6 deform_sample_cols,
K8 fused_bottleneck) against its plain PyTorch version at the main paths'
shapes (batch 2: the cascade's 25x42 map with 9/25/49 taps, the five levels
of the serial family with 9 taps, the 200x336 layer1 input), in f32 (rtol
1e-5, atol 1e-4; for K3, whose f32 atomics sum in an order that changes from
run to run, atol 1e-4 of the largest sum) and in bf16 (the kernel's max
error against an f32 plain run is at most 2x the bf16 plain run's), with
the median time of the wrapper call by CUDA events, the kernel's own device
time and the number of device activities a call by torch.profiler (every
deformable kernel takes positions and does its index math inside: a call of
K1, K2 or K6 must put exactly one kernel on the device, a call of K3 one
kernel of the port plus at most a fill and a cast; K4 and K5 are called
through their prepared entries on weights kept per dtype, as the model
keeps them, and must be one kernel a call too), each kernel's bound
(the least time the card could take, from the bytes and operations of this
run's inputs) and, for K2, K3 and K6, the time of F.grid_sample and of its
backward as a yardstick that the port never calls; K3 is checked and timed
twice, with taps spread uniformly over the map and with taps near their own
pixel (centre + N(0, 2 cells)), which is where a scatter's adds collide; K8
is called through its prepared entry too (one kernel a call), held against
K5 on the same inputs (f32: within the tolerance, each on its FMA body;
bf16: bit for bit, one tensor-core body), shown by the kernel's name to run
the 16x16 tensor-core body, and checked and timed once more at width 128
(layer2's stride-1 block at layer1's map size, the 8x16 tile). K6 and K3
also at the DCN backbone's stride-2 shapes (phase 12 (c)): layer2.0, map
200x336x128 with 100x168 outputs, and layer4.0, map 50x84x512 with 25x42
outputs, 9 taps around each output pixel's centre, with their
F.grid_sample yardsticks; and at phase 13's shapes: GA-Retina's feature
adaption on P3 (map 100x168x256, stride 1) and ResNeXt-101 32x4d's grouped
DCN at layer2.0 (200x336x256, stride 2) and layer4.0 (50x84x1024, stride
2); and at phase 14's RoIAlign gathers: Faster R-CNN's P2 (map
200x336x256, 1000 RoIs x 196 samples, batch 2) and the C4 map
(50x84x1024, 1000 RoIs x 784 samples, batch 1). K9 greedy_nms
against its loop (inside plain_kernels()), kept indices and scores bit for
bit, at K9_SHAPES (the benchmark's served cascade batch of 8 x 13 rows of
1,000 candidates over 100 steps, batch 1, the RPN's 2 rows of 4,800 over
1,000 steps, one row of 16,384 on the global copy), one kernel a call,
with its wrapper, device and loop ms and its bound. K10 bn_epilogue
against its plain version (the PyTorch chain it replaces) bit for bit in
bf16 and f32 at K10_SHAPES (every epilogue of the served R-50 at the
benchmark's batch of 8, 800x1344: the shift and ReLU, the identity, the
identity with the downsample's shift), one kernel a call, each shape's
wrapper, device and plain ms and bound, and their sum over a forward's 39
launches. After the
build, ptxas's registers and spills a kernel and, by cuobjdump, the bf16
tensor-core instructions and local-memory accesses in the SASS of the
bottleneck bodies of K5 and K8 (fails if a tensor-core instance has none).
Phase 2: serves 2 requests of 2 uint8 images at full width
(configs/kgdet_moment_r50_fpn_1x_deepfashion2.py, bf16, 800x1344, seeded
random weights) through make_predict_fn, checks the launch counts and the
outputs, and compares the last-stage head outputs with the same model on its
plain kernels, in bf16 and in f32.
Phase 3: where the time goes: torch.profiler over served batches run stage
by stage (normalize, backbone, neck, head, decode), giving device time per
stage and per kernel and the device's idle share of the window.
Phase 4: training: builds the same model through init_trainer, takes one
warm-up and two timed steps of make_train_step on seeded synthetic batches
(16 boxes an image), checks the launch counts per step (K2 2, K3 2, K1 0,
K4 1, K5 3), finite loss and gradient norm, a frozen parameter bit-equal and
a free one moved; then holds the autograd Function over K2 and K3 against
the one over their plain versions on the very tensors that the train step's
forward hands the two deformable stages (f32, every output and gradient
within 1e-3 of its scale), and compares, on one batch in f32 and in bf16,
the loss and the gradients of kp_rep_block_2/3 and layer4 between the model
on its kernels and on their plain versions.
Phase 5: the train step by stage (forward backbone / neck / head, loss and
targets, backward, optimizer) under torch.profiler.
Phase 6: the serial family served: phases 2 and 3 on
configs/reppoints_moment_serial_r50_fpn_1x_deepfashion2.py (5-level FPN,
launches K1 10 / K4 1 / K5 3 per forward, every level's refine-stage
outputs compared), and one served batch of the parallel config, whose pts
branch runs K1 at F = 512.
Phase 7: the serial family trained: init_trainer on the serial config, one
warm-up and two timed steps (launches per step K6 10, K3 10, K1 0, K2 0,
K4 1, K5 3), the same checks as phase 4, the autograd Function over K6 and
K3 against the one over their plain versions on the tensors the step hands
the stride-8 and the stride-32 level, the model's gradients with K6+K3
against their plain versions on the same prefix, and the step by stage.
Phase 8 (run on phase 6's model, before phase 7): the ResNet-50 backbone
with the per-block frozen layer1 (prefix_pipeline=False): launches K8 3 /
K5 0 / K4 0, its C2 output against the K4+K5 chain and against the all-plain
route, the chain's bf16 error within 2x the plain chain's, and its time
beside the chain's; what each route puts on the device on its kept weights
(activities, device time): the per-block route's three K8 launches must run
the 16x16 tensor-core body, and the served frozen prefix must put exactly
four activities on the device, K4 and K5 x3.
Phase 9: the evaluation path at full width on the cascade config (bf16,
seeded random weights, val_data as shipped: batch 8, canvases 800x1344 and
1344x800, img_scale (1333, 800); test.score_thr 0): writes a synthetic
DeepFashion2-style validation set of 192 PNGs (NumPy + zlib; 24 batches),
checks that the evaluator scores its own ground truth at all-area AP 1
(bbox and keypoints), holds the last-stage head outputs of the model on its
kernels against on their plain versions on the first batch of 8 of each
canvas (as phase 2 does at batch 2), runs the CLI
kgdet_tpu_torch/tools/test.py in-process (every image once in the results,
both JSON files, 12 / 10 finite numbers on the copypaste lines, launches K1
12 / K4 1 / K5 3 a batch over the batches of both canvases and no other
kernel), holds run_inference's detections of the first batch bit for bit
against a direct make_predict_fn call, and runs multi-scale / flip TTA on 4
images (scales at, below and beyond the canvas buckets). Prints the
image_io backend, host data and predict ms a batch, the CLI's setup,
inference and evaluation seconds, and its img/s over the inference window,
the evaluation and the whole run.
Phase 10: the training loop at full width on the cascade config, train_data
as shipped (batch 8, flip_ratio 0.5, both canvases), on 128 synthetic
training PNGs (16 steps an epoch) and 64 validation PNGs: tools/train.py
in-process for one epoch; again with --resume --max-epochs 1, which
restores and trains nothing (step, epoch, model and momentum bit-equal to
the save, the next learning rate schedule(16), epoch 2's first batch as an
uninterrupted run draws it); again with --resume for epoch 2 and
--validate (launches K2 2 / K3 2 / K4 1 / K5 3 a step and K1 12 / K4 1 /
K5 3 an evaluation batch, finite log records, frozen parameters bit-equal,
a free one moved); tools/test.py --checkpoint on the last step equal to the
last --validate and bit-equal to the runner model's detections; the
Function over K2+K3 on a step's tensors at batch 8 on both canvases.
Prints the loop's img/s by log interval from the runner's own records (no
synchronize but the interval's) over the second epoch of a run of its own
on the training PNGs listed 4 times (64 steps an epoch), beside the
loader's rate alone and the step's alone on a batch on the card, host data ms a batch on one thread,
peak memory, the checkpoint's size and save / restore seconds, and the
step of 8 by stage on each canvas.
Phase 11: data parallel on the cascade config at full width. (a) Two ranks
over gloo sharing the card (kgdet_tpu_torch/tools/dp_step.py under
torchrun, TF32 off) take 4 each of a global batch
of 8 synthetic images (16 boxes an image) from the same seeded weights,
one step in f32 and one in bf16, against one process on all 8: launches a
rank a step K2 2 / K3 2 / K4 1 / K5 3 / K1 0, the ranks' parameters and
momentum bit-equal, the f32 loss terms within 1e-4 relative, grad_norm
the norm of the summed gradients and no further from one process's than
they are, the f32 gradients by the whole-model rule (against one process
on all 8 every element but in layer2-4, whose cuDNN rounding the batch
size changes; against one process summing the ranks' shards at their
batch, every element), the bf16 2-rank error against the f32 one-process
step at most BF16_RATIO times the bf16 one-process error; then the same
ranks infer phase 9's first 32 PNGs in f32, sharded and gathered (every
image once, within F32_TOL of one process, K1 12 / K4 1 / K5 3 a batch).
(b) One rank over NCCL under torchrun: tools/train.py --distributed for
an epoch on phase 10's first 32 training PNGs (finite records, one
checkpoint), then tools/test.py --distributed --checkpoint, its JSON equal
to the same CLI without --distributed. (c) The learning proof of
tests/test_torch_train.py in bf16 through K2 / K3 / K4 / K5: the tiny
cascade, adam at 2e-3, up to 300 steps on two fixed images, loss under a
quarter of its start, bbox AP@0.5 >= 0.5 and 0.3 over the untrained model,
keypoint error < 4 px. Prints each part's seconds and the 2-rank step ms
beside one process's (two ranks sharing one card: no scaling figure).

Phase 12: the anchor families and the DCN backbone at full width, seeded
random weights, test.score_thr 0. (a) RetinaNet (the recipe of mmdetection
v1.x's retinanet_r50_fpn_1x, built from the cascade config: 5-level FPN
without norm, RetinaHead with 4 stacked convs, 9 anchors a location),
bf16: 2 requests of 2 served at 800x1344 (K4 1 / K5 3 a forward, nothing
else), the head outputs against the plain kernels as phase 2 holds them,
2 train steps through init_trainer (K4 1 / K5 3 a step, finite logs, a
frozen parameter bit-equal, retina_cls moved). (b)
configs/ssd300_vgg16_deepfashion2.py as shipped (f32, batch 32, 300x300;
no TPU kernel on its path in either package): 2 batches served (K9
alone, once a batch) and 2 train steps with every counter at 0, then
tools/train.py --validate for one epoch of 2 steps on 64 synthetic
training PNGs and 32 validation PNGs with the config's photometric
distortion, expand and min-IoU crop
(finite records, one checkpoint, the bbox copypaste line). (c) The
cascade config with backbone.dcn_stages=(1, 2, 3) (DCN v1 in c3-c5, as
mmdetection v1.x's dconv_c3-c5 configs), bf16: the offset convs given
seeded weights so that the taps leave the pixel grid (about 0.25 cell),
2 requests of 2 served (K1 12 / K4 1 / K5 3 / K6 13 a forward), C3-C5 and
the last-stage head outputs against the plain kernels (f32 within F32_TOL
with atol scaled by each map's largest value, the prefix the same on both
sides; bf16 within BF16_RATIO x the plain model's error), 2 train steps
(K2 2 / K3 15 / K4 1 / K5 3 / K6 13 a step), the DCN's deform_conv (the
Function over K6+K3 and the contraction) against its plain version on
the step's own tensors of layer2.0 (stride 2) and layer4.1 (stride 1),
and the model's gradients against the plain kernels' with the prefix the
same on both sides (the whole-model rule) and in bf16. (d)
kgdet_tpu_torch/tools/benchmark.py --synthetic as its own process on the
cascade config (batch 2, 32 images) and on SSD300 (batch 32, 256 images):
exit 0 and its Overall fps line, echoed. (a) to (c) also print the served
batch's and the train step's profile by stage, as phases 3 and 5 do.

Phase 13: GA-Retina, FCOS and the backbone and neck extras, seeded random
weights, bf16, test.score_thr 0. (a) GA-Retina (mmdetection v1.x's
ga_retinanet_r50_caffe_fpn_1x as far as the config expresses it, built in
code: caffe-style ResNet-50, FPN P3-P7, GARetinaHead with 4 stacked convs
of 256), 2 requests of 2 served (K4 1 / K5 3 / K6 10 a forward), the head
outputs against the plain kernels as phase 2 holds them, 2 train steps (K3
10 / K4 1 / K5 3 / K6 10 a step, retina_cls moved, a frozen parameter
bit-equal), the Function over K6+K3 on the step's P3 tensors of
feature_adaption_cls, the model's gradients against the plain kernels'
(the whole-model rule, the prefix the same on both sides) and in bf16.
(b) FCOS (fcos_r50_caffe_fpn_gn_1x, built the same way): served and
trained with K4 1 / K5 3 and nothing else, the head outputs against the
plain prefix. (d) The backbone and neck of each of the four two-stage
configs (faster_rcnn_r50_caffe_c4, faster_rcnn_x101_32x4d_fpn,
faster_rcnn_hrnetv2p_w32, libra_faster_rcnn_r50_fpn) as the files ship,
through build_backbone / build_neck: one bf16 step at batch 2 on 800x1344
(forward, backward, SGD; finite outputs and gradients, frozen parameters
bit-equal, peak memory), then ResNeXt-101 32x4d with grouped DCN in c3-c5
(K6 30 a forward, K3 30 a step), its C3-C5 against the plain kernels. (a)
and (b) also print the served batch's and the train step's profile by
stage.

Phase 14: the box-only two-stage detectors, seeded random weights,
test.score_thr 0, each config file as it ships (batch 2 at 800x1344, its
own dtype). (a) configs/faster_rcnn_r50_fpn_1x_deepfashion2.py (bf16): 2
requests of 2 served through make_predict_fn (K4 1 / K5 3 / K6 5 a
forward, one K6 a FPN level of the RoI gather; finite detections, img/s,
peak memory), the served batch by stage under torch.profiler (backbone,
neck, RPN head, proposals with their NMS, RoI extraction, box head,
decode), the model against its plain kernels with the proposals pinned
(the RPN's maps compared directly; the RoI head fed the kernel run's
proposals through the external-proposal input on both sides; f32 within
MODEL_F32_REL of scale, bf16 within BF16_RATIO x the plain model's
error), one bf16 train step through init_trainer (K3 5 more; finite loss
terms and acc, frozen parameters bit-equal, fc_cls moved, ms and peak
memory), and the gradients of the model on K6+K3 against on their plain
versions with the prefix the same on both sides (the whole-model rule)
and in bf16. (b) The seven other box-only configs (RPN; Fast R-CNN on
1000 jittered box proposals an image; Cascade, K6 15 a forward; C4, K6 1;
Libra; ResNeXt-101 32x4d and HRNet-W32, no frozen prefix): one served
batch and one step each with their launch counts, finiteness, img/s, step
ms and peak memory (HRNet's random levels are scaled to unit RMS at
HRFPN's output convs: at an RMS of 4e8 no proposal stays inside the
image). (c) tools/train.py --validate on Faster R-CNN (16 training PNGs
at the shipped batch of 8, 4 validation PNGs at batch 2; finite records,
a checkpoint, the bbox copypaste line), tools/test.py on RPN (its
proposal_AR_copypaste line) and on Fast R-CNN with a .pkl of jittered box
proposals written by the phase (the bbox copypaste line).
Phase 15, the mask families and GA-RPN, batch 2 at 800x1344: (a)
configs/mask_rcnn_r50_fpn_1x_deepfashion2.py (f32) served with masks (K4 1
/ K5 3 / K6 10 a forward: 5 levels for the boxes, 5 for the masks;
detections with (B, 100, 28, 28) mask probabilities), profiled by stage
(phase 14's stages and the mask RoIs and mask head), held against its
plain kernels with the proposals pinned (in f32 the box head and the mask
logits within 1e-5 of scale, the RPN's maps within MODEL_F32_REL), one
train step with 16
ground-truth masks an image (K6 11: one more for the mask targets, the
32 masks as the channels of one map; K3 10), its gradients on K6+K3
against their plain versions (the whole-model rule, the prefix the same on
both sides). (b) Mask Scoring R-CNN and HTC (with random stuff maps) as
they ship, Grid R-CNN and the GA-RPN Faster R-CNN built from the Faster
R-CNN config: one served batch and one step each with their launch
counts (HTC K6 24 a forward, 25 and K3 24 a step). (c) Segm evaluation on
20 synthetic PNGs with polygon annotations: the evaluator scores the
ground truth's masks as detections at AP 1.0, and tools/test.py --eval
bbox segm runs Mask R-CNN (both copypaste lines, a segm result an image
with detections). Phase 1 also holds K6 / K3 at the mask RoIs (P2 200x336x256,
2 x 512 RoIs x 784 samples) and the mask targets' map (200x336x32, 512 RoIs
x 3136 samples).
Phase 16, the utilities on the cascade config at full width (seeded random
weights): (a) utils/bn_calibration.py::calibrate_frozen_bn over two
synthetic batches of 2 (every FrozenBatchNorm set, finite stats, the
stem's away from (0, 1)), then one served batch on the refolded prefix (K1
12 / K4 1 / K5 3) and the calibrated prefix on K4 / K5 against the plain
prefix on the same weights (F32_TOL of the output's scale in f32,
BF16_RATIO in bf16); (b)
tools/test_robustness.py in-process on 8 synthetic PNGs, 2 corruptions x
2 severities (K1 12 / K4 1 / K5 3 a forward, the JSON's five settings);
(c) tools/profile.py --mode infer and --mode train at batch 2, 2 steps
(the Chrome trace names K1, K4, K5, K9, resp. K2, K3, K4, K5 among its device
kernels); (d) tools/get_flops.py at 1280x800 (K1's 12 calls
by PERF.md section 6's formula); (e) tools/visualize.py on one PNG (the
output differs from the input on every drawn box's outline).

Every launch check above counts K9 too: once a served batch (the decode's
NMS), twice a two-stage forward (the proposals', the detections'; once
for RPN and Fast R-CNN), once a two-stage train step (the proposals), once
an image under TTA (one NMS over the merged variants), never in a
single-stage train step, and never inside plain_kernels(). And K10: 39 a
served forward of every R-50 trunk (26 with DCN in c3-c5, 99 on
ResNeXt-101, 220 on HRNet-W32, 39 on C4 with res5), per batch and per TTA
variant, never in a train step, a BN calibration or plain_kernels().

Prints the card's name and power limit, one line per check, a JSON line of
the nine kernels (launches on each main path, the evaluation CLI's
and phases 12 to 16 included, error, wrapper and device times, bound), and as
its last line {"ok": true, "device": {...}}. Exits
nonzero, with no result line, when a check fails or no CUDA device is
present. Imports nothing of JAX and nothing of the JAX package.
``--phases`` runs a subset of the phase groups while developing and then
prints no result line; the check runs them all, with no argument.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

from kgdet_tpu_torch.tools.profile import device_profile, short_name

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs',
                      'kgdet_moment_r50_fpn_1x_deepfashion2.py')
SERIAL_CONFIG = os.path.join(
    ROOT, 'configs', 'reppoints_moment_serial_r50_fpn_1x_deepfashion2.py')
PARALLEL_CONFIG = os.path.join(
    ROOT, 'configs', 'reppoints_moment_parallel_r50_fpn_1x_deepfashion2.py')
# the five levels of the serial family on the canvas: strides 8 to 128
SERIAL_LEVELS = ((100, 168), (50, 84), (25, 42), (13, 21), (7, 11))
B = 2
CANVAS = (800, 1344)
SEED = 0
F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF16_RATIO = 2.0
# tight f32 bound, relative to each output's scale: both sides are f32 end
# to end and differ only in summation order
MODEL_F32_REL = 1e-3
# f32 gradients of the whole model on its kernels against the whole model on
# their plain versions, relative to each gradient's largest value: no
# element may differ by more. The bound is loose because the gradients of a
# ReLU network are not continuous. The block applies a ReLU to the
# Function's output, and a pre-activation within rounding of zero falls on
# different sides in the two models: the loss does not move, but that
# pixel's cotangent of that channel is there or is not, which changes one
# term of the sums in one channel's slice of one weight gradient, and a
# little of every gradient upstream. Over 650 batches and weight states
# (NVIDIA H100 80GB HBM3, 700 W; kgdet_tpu_torch/tools/grad_discontinuity.py)
# 17 had an element beyond 1e-3, the worst at 4.5e-3 of its scale, in 0.1%
# of one weight's elements or a few elements of a small parameter (3e-5 of
# the compared elements); the median of the worst difference was 8e-6.
# A difference in the frozen prefix (1e-6 in its f32 output) passes many
# more ReLUs and moves single weights by 1e-2, as one bit of one input
# pixel does. So K2 and K3 are held to MODEL_F32_REL where no ReLU
# intervenes (the Function on the train step's own tensors), and the model
# with the prefix kept the same on both sides is held to MODEL_F32_REL in
# all but MODEL_FLIP_SHARE of the compared elements
MODEL_GRAD_REL = 5e-2
MODEL_FLIP_SHARE = 1e-2
# published peaks of the H100 SXM (NVIDIA data sheet): device memory rate,
# dense bf16 tensor-core rate, f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {'bf16': 989e12, 'f32': 67e12}
TRAIN_STEPS = 2
SERVED = 2
# RoIs an image at test time (test proposals of every two-stage config)
ROI_COUNT = 1000
# K9's shapes in phase 1: images, classes (0: the proposals' (B, N)
# scores), candidates a row, steps, IoU threshold
K9_SHAPES = {'served': (8, 13, 1000, 100, 0.5),
             'batch1': (1, 13, 1000, 100, 0.5),
             'rpn': (2, 0, 4800, 1000, 0.7),
             'global': (1, 1, 16384, 100, 0.5)}
# K10's shapes in phase 1: every epilogue of a served R-50 forward at the
# benchmark's batch of 8 on the 800x1344 canvas, by case: channels, map,
# what it adds (shift alone with the ReLU; the identity; the identity with
# the downsample's shift) and its calls a forward. A layer's block 0 runs
# conv1 at the layer's input map, its conv3 with the downsample; conv1 of
# the other blocks and every conv2 at the output map, 13 x 3 = 39 calls
K10_BATCH = 8
K10_SHAPES = {
    f'layer{i}_{case}': (c, hw, mode, n)
    for i, planes, blocks, hw_in, hw_out in (
        (2, 128, 4, (200, 336), (100, 168)),
        (3, 256, 6, (100, 168), (50, 84)),
        (4, 512, 3, (50, 84), (25, 42)))
    for case, c, hw, mode, n in (
        ('0_conv1', planes, hw_in, 'shift', 1),
        ('conv1_conv2', planes, hw_out, 'shift', 2 * blocks - 1),
        ('0_conv3', 4 * planes, hw_out, 'identity_shift', 1),
        ('conv3', 4 * planes, hw_out, 'identity', blocks - 1))}
# the epilogues of a served forward, each block's conv1, conv2 and conv3:
# R-50 (and every trunk built on it) 13 blocks in layers 2 to 4 behind the
# frozen prefix; with DCN in c3-c5 conv2's BN stays a BN; ResNeXt-101 33
# blocks and HRNet-W32 every block (no prefix); C4 layers 2 and 3 in the
# backbone and res5 over the RoI features
R50_EPILOGUES = 39


def fail(msg):
    raise SystemExit(f'chip_smoke: FAIL: {msg}')


def gpu_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ''


def build_report(build, logs):
    """What nvcc made of the kernels: ptxas's registers and spills a kernel
    (from the build's logs), and for the frozen-bottleneck bodies of
    libresblock.so (K8) and libstem_layer1.so (K5) the count of bf16
    tensor-core instructions (HMMA.16816.F32.BF16) and of local-memory
    loads and stores (LDL, STL: spills) in their SASS, by cuobjdump. Fails
    unless every instance of the tensor-core body (bottleneck_mma_kernel)
    holds the bf16 MMA."""
    for name, log in logs.items():
        fn = ''
        for line in log.splitlines():
            m = re.search(r"entry function '(\w+)'", line)
            fn = m.group(1) if m else fn
            if 'registers' in line or 'spill' in line:
                print(f'  {name} {fn[:72]}: {line.strip()}')
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), 'cuobjdump')
    for name in ('resblock', 'stem_layer1'):
        sass = subprocess.run([cuobjdump, '-sass', str(build.lib_path(name))],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        parts = re.split(r'Function : (\S+)', sass)
        for fn, body in zip(parts[1::2], parts[2::2]):
            if 'bottleneck' not in fn:
                continue
            hmma = body.count('HMMA.16816.F32.BF16')
            local = len(re.findall(r'\b(?:LDL|STL)\b', body))
            tile = re.search(r'ILi(\d+)ELi(\d+)E', fn)
            what = f'tile {tile.group(1)}x{tile.group(2)}' if tile else ''
            print(f'  SASS lib{name}.so {fn[:48]} {what}: '
                  f'HMMA.16816.F32.BF16 x{hmma}, LDL/STL x{local}',
                  flush=True)
            if 'bottleneck_mma_kernel' in fn and hmma == 0:
                fail(f'{fn} in lib{name}.so has no bf16 tensor-core MMA')


def median_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def tensors(out):
    """A kernel's result, a tensor or nested sequences of them, as a flat
    list."""
    import torch
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in tensors(o)]


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, ops, kind):
    """(ms, 'bytes' | 'operations'): the least time the card could take,
    the larger of bytes over the memory rate and operations over the peak
    rate of their type."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    return max(by_bytes, by_ops), 'bytes' if by_bytes >= by_ops \
        else 'operations'


def check_pair(name, kernel, plain, args_f32, cast_bf16, scaled=False):
    """Kernel vs plain on the same inputs, every output tensor: f32 within
    F32_TOL (``scaled``: atol times the output's largest value, for sums
    whose order changes from run to run); bf16 kernel error vs the f32 plain
    run at most BF16_RATIO x the bf16 plain run's (an output that both
    compute in f32 from the same bf16 values differs only by summation
    order, and is held to the f32 tolerance instead).
    Returns (measurements, bf16 args): the f32 max err, the bf16 medians by
    CUDA events of the wrapper call (``ms``) and of the plain version, the
    kernel's own device time a call (``device_ms``), the device activities
    a call (``device_kernels``, whatever torch the wrapper runs included)
    and the port's own kernels among them (``own_kernels``), all three by
    torch.profiler."""
    import torch
    got, want = tensors(kernel(*args_f32)), tensors(plain(*args_f32))
    torch.cuda.synchronize()
    e32 = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            fail(f'{name}: shape {tuple(g.shape)} != {tuple(w.shape)}')
        atol = F32_TOL['atol'] * (max(1.0, w.abs().max().item())
                                  if scaled else 1.0)
        if not torch.allclose(g.float(), w.float(), rtol=F32_TOL['rtol'],
                              atol=atol):
            fail(f'{name} f32: max abs err {max_err(g, w):.3e} over '
                 f'rtol {F32_TOL["rtol"]} atol {atol:.1e}')
        e32 = max(e32, max_err(g, w))
    if len(got) != len(want):
        fail(f'{name}: {len(got)} outputs != {len(want)}')

    args16 = cast_bf16(args_f32)
    ref = tensors(plain(*[a.float() if torch.is_tensor(a)
                          and a.is_floating_point() else a for a in args16]))
    k16, p16 = tensors(kernel(*args16)), tensors(plain(*args16))
    torch.cuda.synchronize()
    ek = ep = 0.0
    for k, p, r in zip(k16, p16, ref):
        eki, epi = max_err(k, r), max_err(p, r)
        floor = 0.0
        if k.dtype == torch.float32:
            floor = F32_TOL['atol'] * max(1.0, r.abs().max().item())
        if not torch.isfinite(k.float()).all() \
                or eki > max(BF16_RATIO * epi, floor):
            fail(f'{name} bf16: kernel err {eki:.3e} > {BF16_RATIO} x plain '
                 f'err {epi:.3e}')
        ek, ep = max(ek, eki), max(ep, epi)
    ms = median_ms(lambda: kernel(*args16))
    pms = median_ms(lambda: plain(*args16))
    dms, n_dev, n_own = device_profile(lambda: kernel(*args16))
    print(f'{name}: f32 max_abs_err {e32:.3e} | bf16 max_abs_err vs f32 '
          f'plain: kernel {ek:.3e}, plain {ep:.3e} | bf16 median ms: '
          f'kernel {ms:.4f} (on the device {dms:.4f}, {n_dev:g} device '
          f'activities a call), plain {pms:.4f}', flush=True)
    return {'max_abs_err': e32, 'ms': ms, 'plain_ms': pms, 'device_ms': dms,
            'device_kernels': n_dev, 'own_kernels': n_own}, args16


def entry(measured, bound_ms, bound_by, library_ms=None):
    return {**measured, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': library_ms}


def merge(entries, calls=1):
    """One row for several shapes of one kernel, ``calls`` launches of each
    on the main path: times and bounds add up, the error and the device
    activities a call are the largest."""
    measured = {k: calls * sum(e[k] for e in entries)
                for k in ('ms', 'plain_ms', 'device_ms')}
    for k in ('max_abs_err', 'device_kernels', 'own_kernels'):
        measured[k] = max(e[k] for e in entries)
    worst = max(entries, key=lambda e: e['bound_ms'])
    library = None if any(e['library_ms'] is None for e in entries) \
        else calls * sum(e['library_ms'] for e in entries)
    return entry(measured, calls * sum(e['bound_ms'] for e in entries),
                 worst['bound_by'], library_ms=library)


def phase_kernels(torch, gen):
    import torch.nn.functional as F

    from kgdet_tpu_torch.ops import deform_kernels as dk
    from kgdet_tpu_torch.ops import nms, plain_kernels
    from kgdet_tpu_torch.ops import resblock as rb
    from kgdet_tpu_torch.ops import stem_kernels as sk
    from kgdet_tpu_torch.ops.deform import bilinear_gather
    from kgdet_tpu_torch.ops.roi import roi_positions
    from tests.kernel_inputs import nms_boxes

    dev = 'cuda'
    bf16 = torch.bfloat16

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen) * std).to(dev)

    def rand_pos(H, W, P, K, b=B):  # up to 2 cells outside the map
        pos = torch.rand((b, P, K, 2), generator=gen).to(dev)
        return pos * torch.tensor([H + 4.0, W + 4.0], device=dev) - 2.0

    def near_pos(H, W, K):          # every tap near its own pixel
        ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W),
                                indexing='ij')
        centre = torch.stack([ys, xs], dim=-1).reshape(1, H * W, 1, 2)
        noise = 2.0 * torch.randn((B, H * W, K, 2), generator=gen)
        return (centre + noise).to(dev)

    def out_bytes(fn, args):
        return nbytes(*tensors(fn(*args)))

    def dcn_pos(Ho, Wo, stride):    # a DCN's taps: its 3x3 grid around
        # the output pixel's centre (stride x its index), moved by N(0, 0.5)
        ys, xs = torch.meshgrid(torch.arange(Ho), torch.arange(Wo),
                                indexing='ij')
        centre = stride * torch.stack([ys, xs], dim=-1).reshape(
            1, Ho * Wo, 1, 2)
        grid = torch.tensor([(dy, dx) for dy in (-1, 0, 1)
                             for dx in (-1, 0, 1)]).reshape(1, 1, 9, 2)
        noise = 0.5 * torch.randn((B, Ho * Wo, 9, 2), generator=gen)
        return (centre + grid + noise).to(dev)

    def cast(args):                 # K1's (feat, pos, weight) in bf16
        f, p, wt = args
        return [f.to(bf16), p, wt.to(bf16)]

    def k1_ops(P, t, C, F):
        # the contraction, plus 7 operations a sampled value for the lerp
        return 2 * B * P * t * C * F + 7 * B * P * t * C

    def library_sampling(feat, pos, g):
        """F.grid_sample and its backward on the taps of K2 / K3 / K6, a
        yardstick only: checked in f32 to be the same function as the plain
        gather, then timed in bf16 (f32 where the library lacks bf16).
        feat (B,H,W,C), pos (B,P,K,2), cotangent g (B,P,K,C). Returns
        (forward ms, backward ms, f32 max err, dtype timed)."""
        H, W = feat.shape[1:3]

        def as_grid(dtype):         # (y, x) pixels -> normalized (x, y)
            return torch.stack([2 * pos[..., 1] / (W - 1) - 1,
                                2 * pos[..., 0] / (H - 1) - 1],
                               dim=-1).to(dtype)

        def grid_sample(x, grid):
            return F.grid_sample(x, grid, mode='bilinear',
                                 padding_mode='zeros', align_corners=True)
        nchw = feat.permute(0, 3, 1, 2).contiguous()
        lib32 = grid_sample(nchw, as_grid(torch.float32)).permute(0, 2, 3, 1)
        err = max_err(lib32, bilinear_gather(feat, pos))
        if err > 1e-3:
            fail(f'grid_sample is not the same function: max err {err:.3e}')
        g_nchw = g.permute(0, 3, 1, 2).contiguous()

        def timed(dtype):
            x = nchw.to(dtype).requires_grad_(True)
            grid = as_grid(dtype).requires_grad_(True)
            with torch.no_grad():
                fwd = median_ms(lambda: grid_sample(x, grid))
            out = grid_sample(x, grid)
            ct = g_nchw.to(dtype)
            return fwd, median_ms(lambda: torch.autograd.grad(
                out, (x, grid), ct, retain_graph=True))
        try:
            return (*timed(bf16), err, bf16)
        except RuntimeError as exc:  # the library lacks a bf16 grid_sample
            print(f'grid_sample in bf16: {str(exc)[:80]}; timed in f32')
            return (*timed(torch.float32), err, torch.float32)

    def one_launch(name, measured, others=0):
        # positions in, index math in the kernel: a call is one kernel of
        # the port and at most ``others`` other activities (a fill, a cast)
        if measured['own_kernels'] != 1 or \
                measured['device_kernels'] > 1 + others:
            fail(f'{name}: a call put {measured["device_kernels"]:g} '
                 f'activities on the device, {measured["own_kernels"]:g} of '
                 f'them the port\'s kernels, not one kernel and at most '
                 f'{others} others')

    def cast_bwd(a):                # K3's (feat, pos, g) in bf16
        return [a[0].to(bf16), a[1], a[2].to(bf16)]

    def check_bwd(name, feat, pos, g, library_ms):
        m, a16 = check_pair(
            f'K3 deform_sample_bwd {name} (sums by f32 atomics: their '
            f'order varies)', dk.deform_sample_bwd, dk.deform_sample_bwd_ref,
            [feat, pos, g], cast_bwd, scaled=True)
        one_launch(f'K3 deform_sample_bwd {name}', m, others=2)
        # a sampled value: 8 operations of scatter, 18 of the dot products
        return entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_sample_bwd, a16),
            26 * g.numel(), 'f32'), library_ms=library_ms)

    results = {}
    # K1 at the three column widths: map 25x42x256, P = 1050, F = 256
    H, W, C = 25, 42, 256
    P = H * W
    k1 = []
    for t in (9, 25, 49):
        feat = randn(B, H, W, C)
        pos = rand_pos(H, W, P, t)
        w = randn(t, C, C, std=(t * C) ** -0.5)
        m, a16 = check_pair(
            f'K1 deform_fused t={t}', dk.deform_conv_fused,
            dk.deform_conv_fused_ref, [feat, pos, w], cast)
        one_launch(f'K1 deform_fused t={t}', m)
        k1.append(entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_conv_fused, a16),
            k1_ops(P, t, C, C), 'bf16')))
    # 4 calls per column and forward: 2 deformable stages x 2 branches
    results['deform_fused'] = merge(k1, calls=4)

    # K2 and K3 at the training shapes: both branch maps, all 83 taps
    taps = (9, 25, 49)
    K = sum(taps)
    cls_feat, pts_feat = randn(B, H, W, C), randn(B, H, W, C)
    pos = rand_pos(H, W, P, K)
    m, a16 = check_pair(
        'K2 deform_sample_split', dk.deform_sample_split,
        dk.deform_sample_split_ref, [cls_feat, pts_feat, pos, taps],
        lambda a: [a[0].to(torch.bfloat16), a[1].to(torch.bfloat16), a[2],
                   a[3]])
    one_launch('K2 deform_sample_split', m)
    cat = torch.cat([cls_feat, pts_feat], dim=-1)
    g = randn(B, P, K, 2 * C)
    lib_ms, lib_bwd_ms, lib_err, lib_dtype = library_sampling(cat, pos, g)
    n_samples = B * P * K * 2 * C
    results['deform_sample_split'] = entry(m, *bound(
        nbytes(*a16[:3]) + out_bytes(dk.deform_sample_split, a16),
        7 * n_samples, 'f32'), library_ms=lib_ms)
    print(f'K2 yardstick F.grid_sample ({lib_dtype}, NCHW, never called by '
          f'the port): {lib_ms:.4f} ms, f32 max err vs plain {lib_err:.3e}',
          flush=True)

    results['deform_sample_bwd'] = check_bwd('uniform taps', cat, pos, g,
                                             lib_bwd_ms)
    pos = near_pos(H, W, K)
    _, near_bwd_ms, _, _ = library_sampling(cat, pos, g)
    results['deform_sample_bwd']['near'] = check_bwd(
        'taps near their pixel', cat, pos, g, near_bwd_ms)
    print(f'K3 yardstick backward of F.grid_sample ({lib_dtype}): uniform '
          f'taps {lib_bwd_ms:.4f} ms, near taps {near_bwd_ms:.4f} ms',
          flush=True)

    # K2 and K3 at the training loop's shapes on the portrait canvas: batch
    # 8 (the shipped train_data.batch_size), the 1344x800 canvas's 42x25
    # map at stride 32
    B8, H8, W8 = 8, 42, 25
    P8 = H8 * W8
    cls8, pts8 = randn(B8, H8, W8, C), randn(B8, H8, W8, C)
    pos8 = rand_pos(H8, W8, P8, K, b=B8)
    name = f'K2 deform_sample_split batch {B8} map {H8}x{W8}'
    m, a16 = check_pair(
        name, dk.deform_sample_split, dk.deform_sample_split_ref,
        [cls8, pts8, pos8, taps],
        lambda a: [a[0].to(torch.bfloat16), a[1].to(torch.bfloat16), a[2],
                   a[3]])
    one_launch(name, m)
    results['deform_sample_split']['b8_42x25'] = entry(m, *bound(
        nbytes(*a16[:3]) + out_bytes(dk.deform_sample_split, a16),
        7 * B8 * P8 * K * 2 * C, 'f32'))
    del a16
    cat8 = torch.cat([cls8, pts8], dim=-1)
    del cls8, pts8
    g8 = randn(B8, P8, K, 2 * C)
    results['deform_sample_bwd']['b8_42x25'] = check_bwd(
        f'batch {B8} map {H8}x{W8}, uniform taps', cat8, pos8, g8, None)
    del cat8, pos8, g8
    torch.cuda.empty_cache()

    # the serial family's five levels, 9 taps a pixel: K1 (serving: the cls
    # and the pts branch of a level), K6 (training forward) and K3 (its
    # backward) on the same maps and positions
    K = 9
    k1s, k6, k3s, k3n = [], [], [], []
    for H, W in SERIAL_LEVELS:
        P = H * W
        feat, pos = randn(B, H, W, C), rand_pos(H, W, P, K)
        w = randn(K, C, C, std=(K * C) ** -0.5)
        g = randn(B, P, K, C)
        m, a16 = check_pair(
            f'K1 deform_fused serial level {H}x{W}', dk.deform_conv_fused,
            dk.deform_conv_fused_ref, [feat, pos, w], cast)
        one_launch(f'K1 deform_fused serial level {H}x{W}', m)
        k1s.append(entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_conv_fused, a16),
            k1_ops(P, K, C, C), 'bf16')))
        lib_fwd, lib_bwd, lib_err, lib_dtype = library_sampling(feat, pos, g)
        n = B * P * K * C
        m, a16 = check_pair(
            f'K6 deform_sample_cols level {H}x{W}', dk.deform_sample_cols,
            dk.deform_sample_cols_ref, [feat, pos],
            lambda a: [a[0].to(bf16), a[1]])
        one_launch(f'K6 deform_sample_cols level {H}x{W}', m)
        k6.append(entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_sample_cols, a16), 7 * n,
            'f32'), library_ms=lib_fwd))
        k3s.append(check_bwd(f'serial level {H}x{W}, uniform taps', feat,
                             pos, g, lib_bwd))
        pos = near_pos(H, W, K)
        _, near_bwd, _, _ = library_sampling(feat, pos, g)
        k3n.append(check_bwd(f'serial level {H}x{W}, taps near their pixel',
                             feat, pos, g, near_bwd))
        print(f'K6 / K3 yardstick F.grid_sample and its backward '
              f'({lib_dtype}, NCHW) level {H}x{W}: {lib_fwd:.4f} / '
              f'{lib_bwd:.4f} ms (backward with near taps {near_bwd:.4f}), '
              f'f32 max err vs plain {lib_err:.3e}', flush=True)
    # a level's two branches: 2 launches a level and forward or step
    results['deform_fused']['serial'] = merge(k1s, calls=2)
    results['deform_sample_cols'] = merge(k6, calls=2)
    results['deform_sample_bwd']['serial'] = merge(k3s, calls=2)
    results['deform_sample_bwd']['serial_near'] = merge(k3n, calls=2)
    # the parallel head's pts branch: kpt | rep weights side by side, F = 512
    H, W = SERIAL_LEVELS[0]
    feat, pos = randn(B, H, W, C), rand_pos(H, W, H * W, K)
    w = randn(K, C, 2 * C, std=(K * C) ** -0.5)
    m, a16 = check_pair(
        f'K1 deform_fused F=512 level {H}x{W}', dk.deform_conv_fused,
        dk.deform_conv_fused_ref, [feat, pos, w], cast)
    one_launch(f'K1 deform_fused F=512 level {H}x{W}', m)
    results['deform_fused']['f512_level0'] = entry(m, *bound(
        nbytes(*a16) + out_bytes(dk.deform_conv_fused, a16),
        k1_ops(H * W, K, C, 2 * C), 'bf16'))
    del feat, pos, w, g, a16

    # 9 taps around each output pixel's centre: K6 (the forward, served
    # and trained) and K3 (its backward) at the DCN backbone's stride-2
    # blocks (phase 12 (c)), layer2.0 (map 200x336x128, outputs 100x168)
    # and layer4.0 (map 50x84x512, outputs 25x42); at GA-Retina's feature
    # adaption on P3 (phase 13 (a): map 100x168x256, stride 1); at
    # ResNeXt-101 32x4d's grouped DCN blocks (phase 13 (d)), layer2.0 (map
    # 200x336x256, stride 2) and layer4.0 (map 50x84x1024, stride 2)
    for label, (H, W, C_dcn), st in (
            ('layer2_0', (200, 336, 128), 2), ('layer4_0', (50, 84, 512), 2),
            ('ga_p3', (100, 168, 256), 1),
            ('x101_layer2_0', (200, 336, 256), 2),
            ('x101_layer4_0', (50, 84, 1024), 2)):
        Ho, Wo = -(-H // st), -(-W // st)
        P = Ho * Wo
        feat, pos = randn(B, H, W, C_dcn), dcn_pos(Ho, Wo, st)
        g = randn(B, P, K, C_dcn)
        lib_fwd, lib_bwd, lib_err, lib_dtype = library_sampling(feat, pos, g)
        name = f'K6 deform_sample_cols DCN {label} map {H}x{W}x{C_dcn} ' \
            f'stride {st}'
        m, a16 = check_pair(name, dk.deform_sample_cols,
                            dk.deform_sample_cols_ref, [feat, pos],
                            lambda a: [a[0].to(bf16), a[1]])
        one_launch(name, m)
        results['deform_sample_cols'][f'dcn_{label}'] = entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_sample_cols, a16),
            7 * B * P * K * C_dcn, 'f32'), library_ms=lib_fwd)
        results['deform_sample_bwd'][f'dcn_{label}'] = check_bwd(
            f'DCN {label} map {H}x{W}x{C_dcn} stride {st}, taps near their '
            f'centre', feat, pos, g, lib_bwd)
        print(f'K6 / K3 yardstick F.grid_sample and its backward '
              f'({lib_dtype}, NCHW) DCN {label}: {lib_fwd:.4f} / '
              f'{lib_bwd:.4f} ms, f32 max err vs plain {lib_err:.3e}',
              flush=True)
        del feat, pos, g, a16
    torch.cuda.empty_cache()

    # RoIAlign's gather (phases 14 and 15): each RoI's n*n bilinear samples
    # (n = out_size * sample_num) on its own image's map, as ops/roi.py
    # hands them to K6 (forward) and K3 (backward): Faster R-CNN's P2 (map
    # 200x336x256, 1000 RoIs x 196 samples, scale 1/4, batch 2), the C4
    # map (50x84x1024, 1000 RoIs x 784 samples, scale 1/16; batch 1: the
    # plain version's f32 check of a batch of 2 would hold ~58 GB), Mask
    # R-CNN's mask RoIs on P2 (a training step's 512 RoIs an image x 784
    # samples, 14x14) and its mask targets' map (the 32 ground-truth masks
    # as channels at 1/4, 512 RoIs x 3136 samples, 28x28)
    for label, (H, W, C_r), stride, out, b, size, R in (
            ('roi_p2', (200, 336, 256), 4, 7, B, (16.0, 100.0), ROI_COUNT),
            ('roi_c4', (50, 84, 1024), 16, 14, 1, (32.0, 600.0), ROI_COUNT),
            ('mask_p2', (200, 336, 256), 4, 14, B, (16.0, 100.0), 512),
            ('mask_targets', (200, 336, 32), 4, 28, B, (16.0, 400.0), 512)):
        K = (out * 2) ** 2
        xy = torch.rand((b, R, 2), generator=gen) \
            * torch.tensor([CANVAS[1] - 64.0, CANVAS[0] - 64.0])
        wh = size[0] + torch.rand((b, R, 2), generator=gen) \
            * (size[1] - size[0])
        pos = roi_positions(torch.cat([xy, xy + wh], -1), out, 1 / stride,
                            2).to(dev)
        feat = randn(b, H, W, C_r)
        g = randn(b, R, K, C_r)
        lib_fwd, lib_bwd, lib_err, lib_dtype = library_sampling(feat, pos, g)
        name = f'K6 deform_sample_cols RoIAlign {label} map {H}x{W}x{C_r}, ' \
            f'{R} RoIs x {K} samples, batch {b}'
        m, a16 = check_pair(name, dk.deform_sample_cols,
                            dk.deform_sample_cols_ref, [feat, pos],
                            lambda a: [a[0].to(bf16), a[1]])
        one_launch(name, m)
        results['deform_sample_cols'][label] = entry(m, *bound(
            nbytes(*a16) + out_bytes(dk.deform_sample_cols, a16),
            7 * b * R * K * C_r, 'f32'), library_ms=lib_fwd)
        del a16
        results['deform_sample_bwd'][label] = check_bwd(
            f'RoIAlign {label} map {H}x{W}x{C_r}, batch {b}', feat, pos, g,
            lib_bwd)
        print(f'K6 / K3 yardstick F.grid_sample and its backward '
              f'({lib_dtype}, NCHW) RoIAlign {label}: {lib_fwd:.4f} / '
              f'{lib_bwd:.4f} ms, f32 max err vs plain {lib_err:.3e}',
              flush=True)
        del feat, pos, g
        torch.cuda.empty_cache()

    def keeping(prepare, run):
        """K4, K5 or K8 through its prepared entry, the prepared weights kept
        per dtype as ResNet.prefix_weights keeps them on the main path: a
        call is then the kernel alone."""
        kept = {}

        def kernel(x, *ws):
            if x.dtype not in kept:
                kept[x.dtype] = prepare(*ws, x.dtype)
            return run(x, kept[x.dtype])
        return kernel

    def prepare_block(*a):
        return sk.prepare_block(dict(zip(sk.BLOCK_KEYS, a[:-1])), a[-1])

    # K4 on both canvas orientations (timed and bounded on the first)
    sw = randn(7, 7, 3, 64, std=(2.0 / 147) ** 0.5)
    sb = randn(64, std=0.1)
    k4 = []
    for hw in (CANVAS, CANVAS[::-1]):
        x = randn(B, *hw, 3)
        name = f'K4 stem_pool {hw[0]}x{hw[1]}'
        m, a16 = check_pair(
            name, keeping(sk.prepare_stem, sk.stem_pool_prepared),
            sk.stem_pool_ref, [x, sw, sb],
            lambda a: [a[0].to(torch.bfloat16), a[1], a[2]])
        one_launch(name, m)
        ops = 2 * B * (hw[0] // 2) * (hw[1] // 2) * 64 * 147
        k4.append(entry(m, *bound(
            nbytes(*a16) + out_bytes(sk.stem_pool, a16), ops, 'bf16')))
    results['stem_pool'] = k4[0]

    def tile_of(fn):
        """The bottleneck body one call of ``fn`` runs: 'fma' or the
        tensor-core body's tile, read off the kernel's name in a profile."""
        seen, tiles = {}, set()
        device_profile(fn, reps=2, names=seen)
        for n in seen['own']:
            m = re.search(r'bottleneck_mma_kernel<(\d+), ?(\d+)>', n)
            tiles.add(f'{m.group(1)}x{m.group(2)}' if m else 'fma')
        return ', '.join(sorted(tiles))

    # K5 for the three layer1 blocks at the stem output shape, and K8, the
    # per-block route's kernel, on the same inputs, both through their
    # prepared entries on weights kept per dtype in the layout they share
    H4, W4 = CANVAS[0] // 4, CANVAS[1] // 4
    k5, k8 = [], []
    for i, cin in enumerate((64, 256, 256)):
        x = torch.relu(randn(B, H4, W4, cin))
        blk = [randn(cin, 64, std=cin ** -0.5), randn(64, std=0.1),
               randn(3, 3, 64, 64, std=(9 * 64) ** -0.5), randn(64, std=0.1),
               randn(64, 256, std=64 ** -0.5), randn(256, std=0.1)]
        blk += ([randn(cin, 256, std=cin ** -0.5), randn(256, std=0.1)]
                if i == 0 else [None, None])
        name = f'K5 frozen_bottleneck block {i} (Cin {cin})'
        k5_kept = keeping(prepare_block, sk.frozen_bottleneck_prepared)
        m, a16 = check_pair(name, k5_kept, sk.frozen_bottleneck_ref,
                            [x] + blk, lambda a: [a[0].to(bf16)] + a[1:])
        one_launch(name, m)
        macs = cin * 64 + 9 * 64 * 64 + 64 * 256 + (cin * 256 if i == 0
                                                    else 0)
        k5.append(entry(m, *bound(
            nbytes(*[a for a in a16 if a is not None])
            + out_bytes(sk.frozen_bottleneck, a16),
            2 * B * H4 * W4 * macs, 'bf16')))
        name = f'K8 fused_bottleneck block {i} (Cin {cin})'
        k8_kept = keeping(prepare_block, rb.fused_bottleneck_prepared)
        m, a16 = check_pair(name, k8_kept, rb.bottleneck_reference, [x] + blk,
                            lambda a: [a[0].to(bf16)] + a[1:])
        one_launch(name, m)
        k8.append(entry(m, *bound(
            nbytes(*[a for a in a16 if a is not None])
            + out_bytes(rb.fused_bottleneck, a16),
            2 * B * H4 * W4 * macs, 'bf16')))
        # f32: each on its FMA body, within the f32 tolerance; bf16: one
        # tensor-core body, the same bits
        if not torch.allclose(k8_kept(x, *blk), k5_kept(x, *blk),
                              **F32_TOL):
            fail(f'K8 and K5 disagree on block {i} in f32')
        x16 = a16[0]
        if not torch.equal(k8_kept(x16, *blk), k5_kept(x16, *blk)):
            fail(f'K8 and K5 differ on block {i} in bf16')
        body = tile_of(lambda: k8_kept(x16, *blk))
        print(f'{name}: bf16 body {body}', flush=True)
        if body != '16x16':
            fail(f'{name} in bf16 ran {body}, not the 16x16 tensor-core body')
    results['frozen_bottleneck'] = merge(k5)
    results['fused_bottleneck'] = merge(k8)
    print('K8 agrees with K5 on the three layer1 blocks within the f32 '
          'tolerance in f32, and bit for bit in bf16', flush=True)
    # K8 at a width the tensor-core body takes on 8x16 tiles: layer2's
    # stride-1 block (512 -> 128 -> 512, identity) at layer1's map size
    x = torch.relu(randn(B, H4, W4, 512))
    blk = [randn(512, 128, std=512 ** -0.5), randn(128, std=0.1),
           randn(3, 3, 128, 128, std=(9 * 128) ** -0.5), randn(128, std=0.1),
           randn(128, 512, std=128 ** -0.5), randn(512, std=0.1), None, None]
    name = 'K8 fused_bottleneck width 128 (Cin 512, Cout 512)'
    k8_kept = keeping(prepare_block, rb.fused_bottleneck_prepared)
    m, a16 = check_pair(name, k8_kept, rb.bottleneck_reference, [x] + blk,
                        lambda a: [a[0].to(bf16)] + a[1:])
    one_launch(name, m)
    body = tile_of(lambda: k8_kept(a16[0], *blk))
    print(f'{name}: bf16 body {body}', flush=True)
    if body != '8x16':
        fail(f'{name} in bf16 ran {body}, not the 8x16 tensor-core body')
    macs = 512 * 128 + 9 * 128 * 128 + 128 * 512
    results['fused_bottleneck']['width128'] = entry(m, *bound(
        nbytes(*[a for a in a16 if a is not None])
        + out_bytes(rb.fused_bottleneck, a16), 2 * B * H4 * W4 * macs,
        'bf16'))
    del x, blk, a16

    # K9 against its loop (inside plain_kernels()), kept indices and
    # scores bit for bit, at its callers' shapes: the cascade's served
    # batch of the benchmark (8 images x 13 classes of 1,000 candidates,
    # 100 steps, thr 0.5, scores the (B, C, N) view of the decode's
    # (B, N, C)), batch 1, the RPN's proposals (2 images of 4,800, 1,000
    # steps, thr 0.7) and one row of 16,384, over what a block can stage
    k9 = {}
    for label, (b, c, n, steps, thr) in K9_SHAPES.items():
        boxes = nms_boxes(gen, b, n, CANVAS).to(dev)
        scores = torch.rand((b, n, max(c, 1)), generator=gen).to(dev)
        args = (boxes[:, None], scores.transpose(1, 2)) if c else \
            (boxes, scores[..., 0].contiguous())
        args += (thr, steps)

        def loop():
            with plain_kernels():
                return nms.greedy_nms(*args)
        got, want = nms.greedy_nms(*args), loop()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f'K9 greedy_nms {label}: kept indices or scores differ '
                 f'from the loop\'s')
        dms, n_dev, n_own = device_profile(lambda: nms.greedy_nms(*args))
        m = {'max_abs_err': 0.0, 'ms': median_ms(
            lambda: nms.greedy_nms(*args)), 'plain_ms': median_ms(
            loop, reps=3, warmup=1),
            'device_ms': dms, 'device_kernels': n_dev, 'own_kernels': n_own}
        name = f'K9 greedy_nms {label} ({args[1].numel() // n} rows of {n}, ' \
            f'{steps} steps)'
        one_launch(name, m)
        print(f'{name}: equal to the loop, {int((got[0] >= 0).sum())} kept '
              f'| median ms: kernel {m["ms"]:.4f} (on the device '
              f'{dms:.4f}, {n_dev:g} device activities a call), plain '
              f'{m["plain_ms"]:.4f}', flush=True)
        ops, n_bytes = nms._k9_cost(*args)
        k9[label] = entry(m, *bound(n_bytes, ops, 'f32'))
    results['greedy_nms'] = k9.pop('served')
    results['greedy_nms'].update(k9)
    results['bn_epilogue'] = k10_served(torch, one_launch)
    for name, r in results.items():
        b = {'greedy_nms': K9_SHAPES['served'][0],
             'bn_epilogue': K10_BATCH}.get(name, B)
        print(f'bound {name}: {r["bound_ms"]:.4f} ms by {r["bound_by"]} '
              f'(wrapper calls {r["ms"]:.4f} ms, kernel on the device '
              f'{r["device_ms"]:.4f} ms, per forward or step of batch {b})',
              flush=True)
        for case in ('near', 'b8_42x25', 'serial', 'serial_near',
                     'width128', 'dcn_layer2_0', 'dcn_layer4_0', 'dcn_ga_p3',
                     'dcn_x101_layer2_0', 'dcn_x101_layer4_0', 'roi_p2',
                     'roi_c4', 'mask_p2', 'mask_targets', *K9_SHAPES,
                     *K10_SHAPES):
            if case in r:
                q = r[case]
                lib = '' if q.get('library_ms') is None \
                    else f', grid_sample {q["library_ms"]:.4f} ms'
                print(f'bound {name}, {case}: {q["bound_ms"]:.4f} ms by '
                      f'{q["bound_by"]} (wrapper calls {q["ms"]:.4f} ms, '
                      f'kernel on the device {q["device_ms"]:.4f} ms{lib})',
                      flush=True)
    return results


def k10_served(torch, one_launch):
    """K10 against bn_epilogue_ref at K10_SHAPES: bit for bit in bf16 and
    f32 (the same roundings, NaN and signed zeros as the chain's), in place;
    one kernel a call; in bf16, as served, the wrapper's, the device's and
    the plain chain's ms and the bound by bytes of each shape, and their sum
    over a forward's calls. Returns the forward's entry with each shape's
    under its case."""
    from kgdet_tpu_torch.ops import bn_epilogue as be

    gen = torch.Generator(device='cuda').manual_seed(SEED + 40)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device='cuda').to(dtype)

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32)

    cases, per_forward = {}, []
    for label, (C, (h, w), mode, calls) in K10_SHAPES.items():
        shift = 0.1 * randn(C)
        id_shift = 0.1 * randn(C) if mode == 'identity_shift' else None
        for dtype in (torch.float32, torch.bfloat16):
            y = randn(K10_BATCH, C, h, w, dtype=dtype).to(
                memory_format=torch.channels_last)
            identity = None if mode == 'shift' else randn(
                K10_BATCH, C, h, w, dtype=dtype).to(
                memory_format=torch.channels_last)
            args = (shift, identity, id_shift)
            want = be.bn_epilogue_ref(y.clone(), *args)
            got = y.clone()
            if be.bn_epilogue(got, *args) is not got or \
                    not torch.equal(bits(got), bits(want)):
                fail(f'K10 bn_epilogue {label} ({mode}, {dtype}): not in '
                     f'place or not the plain chain\'s bits')
        # bf16, as served: timed in place on y (the shift adds up from
        # call to call; the time does not depend on the values)
        m = {'max_abs_err': 0.0,
             'ms': median_ms(lambda: be.bn_epilogue(y, *args)),
             'plain_ms': median_ms(lambda: be.bn_epilogue_ref(y, *args))}
        m['device_ms'], m['device_kernels'], m['own_kernels'] = \
            device_profile(lambda: be.bn_epilogue(y, *args))
        name = f'K10 bn_epilogue {label} ({K10_BATCH}x{C}x{h}x{w} bf16, ' \
            f'{mode}, {calls} a forward)'
        one_launch(name, m)
        _, n_bytes = be._cost(y, *args)
        cases[label] = entry(m, *bound(n_bytes, 0, 'bf16'))
        per_forward += [cases[label]] * calls
        print(f'{name}: the plain chain\'s bits in bf16 and f32 | median '
              f'ms: kernel {m["ms"]:.4f} (on the device '
              f'{m["device_ms"]:.4f}, {m["device_kernels"]:g} device '
              f'activities a call), plain {m["plain_ms"]:.4f}, bound '
              f'{cases[label]["bound_ms"]:.4f}', flush=True)
        del y, identity, want, got
    if len(per_forward) != R50_EPILOGUES:
        fail(f'K10_SHAPES hold {len(per_forward)} calls a forward')
    result = merge(per_forward)
    print(f'K10 bn_epilogue, a served R-50 forward at batch {K10_BATCH} '
          f'({R50_EPILOGUES} calls): on the device '
          f'{result["device_ms"]:.4f} ms, bound {result["bound_ms"]:.4f} ms '
          f'({result["bound_ms"] / result["device_ms"]:.1%} of it), wrapper '
          f'calls {result["ms"]:.4f} ms, plain chain {result["plain_ms"]:.4f} '
          f'ms', flush=True)
    result.update(cases)
    return result


def make_requests(n, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n):
        img = rng.randint(0, 256, (B, *CANVAS, 3)).astype(np.uint8)
        # resized extents inside the canvas, as the loader pads them
        hw = np.array([[800, 1333], [800, 1067]], np.float32)
        sf = np.array([800 / 1200, 800 / 900], np.float32)
        reqs.append({'image': img, 'img_hw': hw, 'scale_factor': sf})
    return reqs


def wrappers():
    """The kernel wrappers of the port, by kernel name."""
    from kgdet_tpu_torch.ops.deform_kernels import (
        deform_conv_fused, deform_sample_bwd, deform_sample_cols,
        deform_sample_split)
    from kgdet_tpu_torch.ops.bn_epilogue import bn_epilogue
    from kgdet_tpu_torch.ops.nms import greedy_nms
    from kgdet_tpu_torch.ops.resblock import fused_bottleneck
    from kgdet_tpu_torch.ops.stem_kernels import frozen_bottleneck, stem_pool
    return {'deform_fused': deform_conv_fused,
            'deform_sample_split': deform_sample_split,
            'deform_sample_bwd': deform_sample_bwd, 'stem_pool': stem_pool,
            'frozen_bottleneck': frozen_bottleneck,
            'deform_sample_cols': deform_sample_cols,
            'fused_bottleneck': fused_bottleneck, 'greedy_nms': greedy_nms,
            'bn_epilogue': bn_epilogue}


def launch_counts(**per_kernel):
    """Expected launches by kernel name, 0 for every kernel not named."""
    return {name: per_kernel.get(name, 0) for name in wrappers()}


def reset_launches():
    for fn in wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in wrappers().items()}


def serve(torch, predict, reqs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets = [predict(r) for r in reqs]
    torch.cuda.synchronize()
    return dets, time.perf_counter() - t0


def last_stage(outs):
    """The last stage's maps of every level: cls, kpt and bbox of the
    point families, cls and bbox of the anchor families, FCOS's
    centerness, GA-Retina's anchor shape and location."""
    return {f'{k} level {lvl}': o[k][-1] for lvl, o in enumerate(outs)
            for k in ('cls', 'kpt', 'bbox', 'centerness', 'shape', 'loc')
            if k in o}


def hold_against_plain(torch, model, batch, where=''):
    """The last-stage head outputs of ``model`` on ``batch``, on its kernels
    against on their plain versions: f32 within MODEL_F32_REL of each
    output's scale, bf16 within BF16_RATIO x the plain bf16 model's error
    from the f32 plain model."""
    from kgdet_tpu_torch.ops import plain_kernels
    from kgdet_tpu_torch.ops.image import device_normalize

    image = device_normalize(torch.as_tensor(batch['image']).cuda(),
                             torch.as_tensor(batch['img_hw']).cuda())
    dtype0 = model.dtype
    try:
        with torch.inference_mode():
            runs = {}
            for dtype in (torch.bfloat16, torch.float32):
                model.dtype = dtype
                for plain in (False, True):
                    with plain_kernels(plain):
                        runs[dtype, plain] = last_stage(model(image))
    finally:
        model.dtype = dtype0
    ref = runs[torch.float32, True]
    for k in ref:
        scale = max(1.0, ref[k].float().abs().max().item())
        e32 = max_err(runs[torch.float32, False][k], ref[k])
        ek = max_err(runs[torch.bfloat16, False][k], ref[k])
        ep = max_err(runs[torch.bfloat16, True][k], ref[k])
        print(f'{where}last stage {k}: f32 kernels vs plain {e32:.3e} (bound '
              f'{MODEL_F32_REL * scale:.3e}); bf16 vs f32 plain: kernels '
              f'{ek:.3e}, plain {ep:.3e} (bound {BF16_RATIO} x plain)',
              flush=True)
        if not e32 <= MODEL_F32_REL * scale:
            fail(f'{where}last stage {k}: f32 kernel model differs by '
                 f'{e32:.3e}')
        if not ek <= BF16_RATIO * ep:
            fail(f'{where}last stage {k}: bf16 kernel model err {ek:.3e} > '
                 f'{BF16_RATIO} x plain {ep:.3e}')


def config_of(config):
    """(config, its name): a config file's, or a config built here with
    the name given beside it as (name, config)."""
    from kgdet_tpu_torch.api import load_config
    if isinstance(config, str):
        return load_config(config), os.path.relpath(config, ROOT)
    return config[1], config[0]


def phase_serving(torch, gpu, config, per_fwd, n_reqs=SERVED, compare=True,
                  prepare=None):
    """Serve ``n_reqs`` requests through make_predict_fn on the config's
    model at full width; check the launch counts per forward and the
    detections; with ``compare``, hold the last-stage head outputs of the
    model on its kernels against the model on their plain versions.
    ``prepare(model, request)``, where given, sets weights before the
    first request."""
    from kgdet_tpu_torch.api import build_model, make_predict_fn
    from kgdet_tpu_torch.models.families import BOX_FAMILIES
    from kgdet_tpu_torch.ops import plain_kernels

    cfg, name = config_of(config)
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, score_thr=0.0))
    print(f'serving: {name} ({cfg.head.type}, '
          f'strides {cfg.head.point_strides}), {cfg.compute_dtype}, canvas '
          f'{CANVAS[0]}x{CANVAS[1]}, batch {B}, random weights (seed {SEED}); '
          f'test.score_thr set to 0.0 so NMS has work under random weights',
          flush=True)
    model = build_model(cfg).init_weights(SEED).eval()
    kpt_width = 3 if cfg.head.type in BOX_FAMILIES \
        else 3 * cfg.head.num_keypts
    if next(model.parameters()).device.type != 'cuda':
        fail('build_model did not place the model on the card')
    predict = make_predict_fn(model, cfg, CANVAS)
    reqs = make_requests(n_reqs, SEED)
    if prepare is not None:
        prepare(model, reqs[0])

    predict(reqs[0])                      # warm-up: cuDNN plans, allocator
    reset_launches()
    dets, secs = serve(torch, predict, reqs)
    got = read_launches()
    want = {k: v * len(reqs) for k, v in per_fwd.items()}
    if got != want:
        fail(f'launch counts {got} != {want} for {len(reqs)} forwards')
    launches = dict(got)
    n_valid = 0
    for d in dets:
        for k, v in d.items():
            if v.is_floating_point() and not torch.isfinite(v).all():
                fail(f'non-finite {k} in the served detections')
        if tuple(d['det_bboxes'].shape) != (B, cfg.test.max_per_img, 5) or \
                tuple(d['det_kpts'].shape) != \
                (B, cfg.test.max_per_img, kpt_width):
            fail(f'detection shapes {[tuple(v.shape) for v in d.values()]}')
        n_valid += int(d['valid'].sum())
    if n_valid == 0:
        fail('no detection survived NMS at score_thr 0')
    ips = B * len(reqs) / secs
    if not compare:
        print(f'serving: {len(reqs)} requests x {B} images, {n_valid} valid '
              f'detections, launches {launches}; {ips:.2f} img/s ({gpu})',
              flush=True)
        return model, cfg, reqs[0], launches

    with plain_kernels():
        predict(reqs[0])
        _, psecs = serve(torch, predict, reqs)
    pips = B * len(reqs) / psecs
    print(f'serving: {len(reqs)} requests x {B} images, {n_valid} valid '
          f'detections, launches {launches}; {ips:.2f} img/s with kernels, '
          f'{pips:.2f} img/s with plain versions ({gpu})', flush=True)

    # last-stage head outputs: kernels vs plain, bf16 and f32
    hold_against_plain(torch, model, reqs[0])
    return model, cfg, reqs[0], launches


def stage_times(prof, stages, span_device, steps):
    """From a profiler run: per stage its span (the labelled ranges on
    ``span_device``) and its device busy time (the kernels whose midpoint
    falls in one of its ranges), and per kernel name (ms, count); ms per
    step."""
    from collections import defaultdict

    from torch.autograd import DeviceType

    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == span_device and e.name in stages]
    span_ms, busy_ms, kern = defaultdict(float), defaultdict(float), {}
    for s0, s1, name in spans:
        span_ms[name] += (s1 - s0) / 1e3 / steps
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in stages \
                or 'spin_kernel' in e.name:
            continue
        ms = (e.time_range.end - e.time_range.start) / 1e3 / steps
        mid = (e.time_range.start + e.time_range.end) / 2
        stage = next((n for s0, s1, n in spans if s0 <= mid <= s1), 'other')
        busy_ms[stage] += ms
        t, n = kern.get(e.name, (0.0, 0))
        kern[e.name] = (t + ms, n + 1)
    return span_ms, busy_ms, kern


def print_top_kernels(kern, steps, top):
    for name, (ms, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f'  {ms:8.3f} ms x{n // steps:<4d} {name[:96]}')


def print_own_kernels(kern, steps, per):
    print(f'  the port\'s kernels, device ms per {per}: ' + ', '.join(
        f'{short_name(name)} {ms:.3f} x{n // steps}'
        for name, (ms, n) in sorted(kern.items()) if 'kgdet::' in name),
        flush=True)


STAGES = ('normalize', 'backbone', 'neck', 'head', 'decode')


def phase_profile(torch, model, cfg, req, gpu, steps=2, plain=False):
    """Where the time goes over `steps` served batches, stages labelled
    here around the calls into each layer: per stage its device span
    (first to last kernel, gaps included) and its busy time (the kernels
    in that span); per kernel its device time; the device's idle share of
    the wall time of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from kgdet_tpu_torch.models.families import get_head_family
    from kgdet_tpu_torch.ops import plain_kernels
    from kgdet_tpu_torch.ops.image import device_normalize

    canvas = tuple(req['image'].shape[1:3])
    decode = get_head_family(cfg.head.type).make_decode(cfg, canvas)
    img = torch.as_tensor(req['image']).cuda()
    img_hw = torch.as_tensor(req['img_hw']).cuda()
    sf = torch.as_tensor(req['scale_factor']).cuda()

    def stages():
        with record_function('normalize'):
            x = device_normalize(img, img_hw)
        with record_function('backbone'):
            feats = model.backbone(x.to(model.dtype))
        with record_function('neck'):
            if model.neck is not None:      # SSD300: the Identity neck
                feats = model.neck(feats)
        with record_function('head'):
            outs = model.bbox_head(feats)
        with record_function('decode'):
            return decode(outs, img_hw, sf)

    @torch.inference_mode()
    def run():
        with plain_kernels(plain):
            return stages()

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    span_ms, busy_ms, kern = stage_times(prof, STAGES, DeviceType.CUDA,
                                         steps)
    busy = sum(busy_ms.values())
    kind = 'plain versions' if plain else 'kernels'
    print(f'profile ({kind}): {steps} batches of {len(img)} at '
          f'{canvas[0]}x{canvas[1]} under torch.profiler: '
          f'{wall:.3f} ms per batch, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.3f} ({gpu})', flush=True)
    print('  stage device span / busy ms per batch: ' + ', '.join(
        f'{s} {span_ms[s]:.3f}/{busy_ms[s]:.3f}' for s in STAGES), flush=True)
    print_top_kernels(kern, steps, 8)
    print_own_kernels(kern, steps, 'batch')


def make_train_batches(n, seed, num_keypts, b=B):
    """Seeded synthetic training batches of ``b`` images: uint8 images, 16
    boxes an image with every keypoint visible, extents inside the
    canvas."""
    import numpy as np
    rng = np.random.RandomState(seed)
    G = 16
    batches = []
    for _ in range(n):
        boxes = np.zeros((b, G, 4), np.float32)
        boxes[..., :2] = rng.uniform(0, 300, (b, G, 2))
        boxes[..., 2:] = boxes[..., :2] + rng.uniform(64, 400, (b, G, 2))
        kpts = rng.uniform(0, 700, (b, G, num_keypts, 3)).astype(np.float32)
        kpts[..., 2] = 1
        batches.append({
            'image': rng.randint(0, 256, (b, *CANVAS, 3)).astype(np.uint8),
            'valid_hw': np.tile(np.array([[800, 1333], [800, 1067]],
                                         np.int32), (b // 2, 1)),
            'gt_bboxes': boxes,
            'gt_labels': rng.randint(1, 14, (b, G)).astype(np.int32),
            'gt_kpts': kpts,
            'gt_mask': np.ones((b, G), bool),
        })
    return batches


def phase_function(torch, model, loss_fn, batch):
    """The autograd Function over K2 and K3 against the one over their plain
    versions, in f32, on the tensors that the train step's forward hands
    the two deformable stages (maps, RepPoints field, the stage's weights)
    and a seeded cotangent. No ReLU lies between the inputs and what is
    compared, so every output and every gradient is held to MODEL_F32_REL
    of its scale."""
    from kgdet_tpu_torch.models.kgdet_head import KpRepBlock
    from kgdet_tpu_torch.ops import plain_kernels
    from kgdet_tpu_torch.ops.deform import absolute_positions
    from kgdet_tpu_torch.ops.deform_kernels import deform_columns_dual

    blocks = {n: m for n, m in model.named_modules()
              if isinstance(m, KpRepBlock) and m.deform}
    caught = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=n: caught.__setitem__(
            n, [a.detach() for a in args])) for n, m in blocks.items()]
    model.dtype = torch.float32
    with torch.no_grad():
        loss_fn(batch)
    for h in hooks:
        h.remove()
    if sorted(caught) != sorted(blocks) or len(blocks) != 2:
        fail(f'the forward ran deformable stages {sorted(caught)} of '
             f'{sorted(blocks)}')
    gen = torch.Generator(device='cuda').manual_seed(SEED + 2)
    names = ('cls_cat', 'kpt_cat', 'grad cls_feat', 'grad pts_feat',
             'grad pos')
    for n, blk in blocks.items():
        cls_feat, pts_feat, field = caught[n]
        Bn, H, W, _ = cls_feat.shape
        taps = blk.column_taps
        pos = absolute_positions(field.reshape(Bn, H, W, sum(taps), 2), H, W)
        weights = [w.detach() for br in ('cls', 'keypts')
                   for w in blk.dfm_weights(br, cls_feat.dtype)]
        cots = [torch.randn((Bn, H * W, sum(w.shape[-1] for w in
                                            weights[:len(taps)])),
                            device='cuda', generator=gen) for _ in range(2)]

        def run(plain):
            leaves = [t.clone().requires_grad_()
                      for t in (cls_feat, pts_feat, pos, *weights)]
            with plain_kernels(plain):
                outs = deform_columns_dual(
                    leaves[0], leaves[1], leaves[2], leaves[3:3 + len(taps)],
                    leaves[3 + len(taps):], taps)
            return [*outs, *torch.autograd.grad(outs, leaves, cots)]
        got, want = run(False), run(True)
        errs = [max_err(g, w) / w.abs().max().item()
                for g, w in zip(got, want)]
        labels = names + tuple(f'grad weight {i}' for i in range(len(weights)))
        worst = max(zip(errs, labels))
        print(f'Function over K2+K3 vs plain on the train step\'s tensors, '
              f'f32, {n} (map {H}x{W}, {sum(taps)} taps): worst of '
              f'{len(errs)} outputs and gradients {worst[0]:.3e} of its '
              f'scale ({worst[1]}; bound {MODEL_F32_REL}; grad_feat by f32 '
              f'atomics)', flush=True)
        if not all(e <= MODEL_F32_REL for e in errs):
            fail(f'f32: the Function over K2 and K3 differs from the one '
                 f'over their plain versions in {n}: '
                 + ', '.join(f'{lb} {e:.3e}' for e, lb in zip(errs, labels)))


GRAD_GROUPS = ('bbox_head.kp_rep_block_2.', 'bbox_head.kp_rep_block_3.',
               'backbone.layer4.')


def take_train_steps(torch, gpu, config, per_step, n_logs, free_name):
    """init_trainer on the config, one warm-up and TRAIN_STEPS timed steps of
    make_train_step on seeded synthetic batches: checks the launch counts
    per step, finite logs (``n_logs`` of them), a frozen parameter bit-equal
    and ``free_name`` moved. Returns (model, cfg, optimizer, batches,
    launches)."""
    from kgdet_tpu_torch.api import init_trainer
    from kgdet_tpu_torch.parallel.train import frozen_param_mask

    cfg, name = config_of(config)
    model, optimizer, train_step = init_trainer(cfg, CANVAS,
                                                steps_per_epoch=1000)
    params = dict(model.named_parameters())
    if next(iter(params.values())).device.type != 'cuda':
        fail('init_trainer did not place the model on the card')
    batches = make_train_batches(1 + TRAIN_STEPS, SEED + 1,
                                 cfg.head.num_keypts)
    frozen = frozen_param_mask(model, cfg.backbone.frozen_stages)
    frozen_name = 'backbone.layer1.0.conv1.weight'
    if not frozen[frozen_name] or frozen[free_name]:
        fail('frozen_param_mask does not split layer1 from the head')
    start = {n: params[n].detach().clone() for n in (frozen_name, free_name)}

    torch.cuda.reset_peak_memory_stats()
    logs = [train_step(batches[0])]         # warm-up: cuDNN plans, allocator
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs += [train_step(b) for b in batches[1:]]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = read_launches()
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    if got != want:
        fail(f'launch counts {got} != {want} for {TRAIN_STEPS} train steps')
    peak = torch.cuda.max_memory_allocated()
    for i, lg in enumerate(logs):
        vals = {k: v.item() for k, v in lg.items()}
        if len(vals) != n_logs or not all(v == v and abs(v) != float('inf')
                                          for v in vals.values()):
            fail(f'train step {i}: logs {vals}')
        print(f'train step {i}: loss {vals["loss"]:.4f} grad_norm '
              f'{vals["grad_norm"]:.4f} ' + ' '.join(
                  f'{k} {v:.0f}' for k, v in vals.items()
                  if k.startswith('num_pos')), flush=True)
    if not torch.equal(params[frozen_name].detach(), start[frozen_name]):
        fail(f'frozen parameter {frozen_name} changed')
    if torch.equal(params[free_name].detach(), start[free_name]):
        fail(f'free parameter {free_name} did not move')
    ms = secs / TRAIN_STEPS * 1e3
    print(f'training: {name}, {TRAIN_STEPS} steps x '
          f'{B} images, {cfg.compute_dtype}, canvas {CANVAS[0]}x{CANVAS[1]}, '
          f'launches {got}; {ms:.2f} ms per step, '
          f'{B * TRAIN_STEPS / secs:.2f} img/s, peak memory '
          f'{peak / 2 ** 30:.3f} GiB ({gpu})', flush=True)
    return model, cfg, optimizer, batches, got


@contextlib.contextmanager
def prefix_on_its_kernels(model):
    """The frozen prefix of ``model`` on its kernels (K4, K5) inside a
    ``plain_kernels()`` block: the head's kernels against their plain
    versions on the same prefix."""
    from kgdet_tpu_torch.ops import plain_kernels
    backbone = model.backbone
    frozen_prefix = backbone.frozen_prefix

    def on_kernels(x):
        with plain_kernels(False):
            return frozen_prefix(x)
    backbone.frozen_prefix = on_kernels
    try:
        yield
    finally:
        del backbone.frozen_prefix


def loss_and_grads(model, optimizer, loss_fn, groups, dtype, plain, batch,
                   same_prefix=False):
    """(loss, {name: f32 gradient} of the parameters under ``groups``) of
    one batch, the model computing in ``dtype`` on its kernels or (``plain``)
    their plain versions; ``same_prefix`` keeps the frozen prefix on its
    kernels either way. The backward runs after the plain block has closed,
    as the autograd Functions recorded it."""
    from kgdet_tpu_torch.ops import plain_kernels
    model.dtype = dtype
    optimizer.zero_grad()
    with plain_kernels(plain), (prefix_on_its_kernels(model) if same_prefix
                                else contextlib.nullcontext()):
        total, _ = loss_fn(batch)
    total.backward()
    return total.item(), {n: p.grad.float().clone()
                          for n, p in model.named_parameters()
                          if n.startswith(groups) and p.grad is not None}


def worst_and_share(run, against):
    """Over the parameters: the largest difference relative to the
    gradient's scale, and the share of all their elements that differ by
    more than MODEL_F32_REL of their parameter's scale."""
    worst, beyond, total = (0.0, ''), 0, 0
    for n, want in against[1].items():
        diff = (run[1][n] - want).abs() / want.abs().max()
        worst = max(worst, (diff.max().item(), n))
        beyond += (diff > MODEL_F32_REL).sum().item()
        total += diff.numel()
    return worst, beyond / total


def check_same_prefix_grads(what, kern32, head32):
    """f32, the model on its sampling kernels against the model on their
    plain versions, the frozen prefix the same on both sides: the loss
    within MODEL_F32_REL, every gradient element within MODEL_GRAD_REL and
    all but MODEL_FLIP_SHARE of them within MODEL_F32_REL of its scale."""
    w_head, flips = worst_and_share(kern32, head32)
    print(f'gradients f32, {what} vs their plain versions on the same '
          f'prefix: loss {kern32[0]:.6f} vs {head32[0]:.6f}; worst of '
          f'{len(head32[1])} parameters {w_head[0]:.3e} of its scale '
          f'({w_head[1]}; bound {MODEL_GRAD_REL}); share of their elements '
          f'beyond {MODEL_F32_REL}: {flips:.3e} (bound {MODEL_FLIP_SHARE})',
          flush=True)
    if not abs(kern32[0] - head32[0]) <= MODEL_F32_REL * abs(head32[0]) \
            or not w_head[0] <= MODEL_GRAD_REL \
            or not flips <= MODEL_FLIP_SHARE:
        fail(f'f32: the model on {what} differs from the model on their '
             'plain versions')


def check_bf16_grads(ref_loss, ref, kern16, plain16, groups,
                     labels=('kernels', 'plain')):
    """bf16 against the f32 plain model: the kernel model's loss error and,
    per parameter group, relative L2 gradient error at most BF16_RATIO x the
    plain model's (``labels`` name the two runs)."""
    (k16_loss, k16), (p16_loss, p16) = kern16, plain16
    # one bf16 rounding of the loss is the least either can be held to
    loss_floor = 2.0 ** -8 * abs(ref_loss)
    ek, ep = abs(k16_loss - ref_loss), abs(p16_loss - ref_loss)
    print(f'loss bf16 vs f32 {labels[1]} {ref_loss:.4f}: {labels[0]} '
          f'{ek:.3e}, {labels[1]} {ep:.3e}', flush=True)
    if not ek <= max(BF16_RATIO * ep, loss_floor):
        fail(f'bf16 {labels[0]}: loss err {ek:.3e} > {BF16_RATIO} x '
             f'{ep:.3e}')
    for group in groups:
        names = [n for n in ref if n.startswith(group)]

        def rel_err(run):
            num = sum((run[n] - ref[n]).square().sum() for n in names)
            return (num / sum(ref[n].square().sum() for n in names)) \
                .sqrt().item()
        ek, ep = rel_err(k16), rel_err(p16)
        print(f'gradients bf16 vs f32 {labels[1]}, {group}* ({len(names)} '
              f'parameters), relative L2 error: {labels[0]} {ek:.3e}, '
              f'{labels[1]} {ep:.3e} (bound {BF16_RATIO} x {labels[1]})',
              flush=True)
        if not ek <= BF16_RATIO * ep:
            fail(f'bf16 {labels[0]}: gradients of {group}* err {ek:.3e} > '
                 f'{BF16_RATIO} x {labels[1]} {ep:.3e}')


def phase_training(torch, gpu):
    from kgdet_tpu_torch.parallel.train import make_loss_fn

    model, cfg, optimizer, batches, got = take_train_steps(
        torch, gpu, CONFIG, launch_counts(
            deform_sample_split=2, deform_sample_bwd=2, stem_pool=1,
            frozen_bottleneck=3),
        n_logs=12, free_name='bbox_head.kp_rep_block_3.cls_out.weight')

    # loss and gradients on one batch: kernels vs plain versions
    loss_fn = make_loss_fn(model, cfg, CANVAS)

    def run(dtype, plain, same_prefix=False, batch=batches[0]):
        return loss_and_grads(model, optimizer, loss_fn, GRAD_GROUPS, dtype,
                              plain, batch, same_prefix)

    def worst_of(run, against):
        return max((max_err(run[1][n], against[1][n])
                    / against[1][n].abs().max().item(), n)
                   for n in against[1])

    f32 = torch.float32
    ref_loss, ref = plain32 = run(f32, True)
    kern32 = run(f32, False)
    phase_function(torch, model, loss_fn, batches[0])
    # K2 and K3 in the model: the plain head on the same (kernel) prefix
    check_same_prefix_grads('K2+K3', kern32, run(f32, True,
                                                 same_prefix=True))
    # all kernels vs all plain: K4 and K5 round their f32 sums in another
    # order (1e-6), and this model's gradients amplify that: shown by the
    # plain model's own change under one bit of one input pixel
    w_all = worst_of(kern32, plain32)
    nudged = dict(batches[0], image=batches[0]['image'].copy())
    nudged['image'][0, 50, 50, 0] ^= 1
    w_sens = worst_of(run(f32, True, batch=nudged), plain32)
    print(f'gradients f32, all kernels vs all plain: loss {kern32[0]:.6f} vs '
          f'{ref_loss:.6f}; worst {w_all[0]:.3e} of its scale ({w_all[1]}; '
          f'bound {MODEL_GRAD_REL}); for scale, the plain model with one '
          f'input pixel changed by 1/255: worst {w_sens[0]:.3e} '
          f'({w_sens[1]})', flush=True)
    if not abs(kern32[0] - ref_loss) <= MODEL_F32_REL * abs(ref_loss) \
            or not w_all[0] <= MODEL_GRAD_REL:
        fail('f32 kernel model: loss or a gradient differs from the plain '
             'model')
    plain16 = run(torch.bfloat16, True)
    check_bf16_grads(ref_loss, ref, run(torch.bfloat16, False), plain16,
                     GRAD_GROUPS)
    optimizer.zero_grad()
    model.dtype = torch.bfloat16
    return model, cfg, optimizer, batches[0], got


SERIAL_GRAD_GROUPS = ('bbox_head.', 'neck.', 'backbone.layer4.')


def phase_serial_function(torch, model, loss_fn, batch):
    """The autograd Function of deform_conv_fused over K6 and K3 against the
    one over their plain versions, in f32, on the tensors that the train
    step's forward hands the stride-8 and the stride-32 level (both
    branches: map, tap positions, weight) and a seeded cotangent. No ReLU
    lies between the inputs and what is compared, so the output and every
    gradient are held to MODEL_F32_REL of their scale."""
    import kgdet_tpu_torch.models.serial_head as serial_head
    from kgdet_tpu_torch.ops import plain_kernels
    from kgdet_tpu_torch.ops.deform_kernels import deform_conv_fused

    calls = []

    def record(feat, pos, weight):
        calls.append((feat.detach(), pos.detach(), weight.detach()))
        return deform_conv_fused(feat, pos, weight)

    model.dtype = torch.float32
    serial_head.deform_conv_fused = record
    try:
        with torch.no_grad():
            loss_fn(batch)
    finally:
        serial_head.deform_conv_fused = deform_conv_fused
    strides = model.bbox_head.point_strides
    if len(calls) != 2 * len(strides):
        fail(f'the forward made {len(calls)} deformable convs over '
             f'{len(strides)} levels')
    gen = torch.Generator(device='cuda').manual_seed(SEED + 3)
    names = ('output', 'grad map', 'grad positions', 'grad weight')
    for lvl in (strides.index(8), strides.index(32)):
        for branch, (feat, pos, weight) in zip(('cls', 'pts'),
                                               calls[2 * lvl:2 * lvl + 2]):
            ct = torch.randn((*pos.shape[:2], weight.shape[-1]),
                             device='cuda', generator=gen)

            def run(plain):
                leaves = [t.clone().requires_grad_()
                          for t in (feat, pos, weight)]
                with plain_kernels(plain):
                    out = deform_conv_fused(*leaves)
                return [out, *torch.autograd.grad(out, leaves, ct)]
            got, want = run(False), run(True)
            errs = [max_err(g, w) / w.abs().max().item()
                    for g, w in zip(got, want)]
            worst = max(zip(errs, names))
            print(f'Function over K6+K3 vs plain on the train step\'s '
                  f'tensors, f32, stride {strides[lvl]} {branch} branch (map '
                  f'{feat.shape[1]}x{feat.shape[2]}, F {weight.shape[-1]}): '
                  f'worst {worst[0]:.3e} of its scale ({worst[1]}; bound '
                  f'{MODEL_F32_REL}; grad map by f32 atomics)', flush=True)
            if not all(e <= MODEL_F32_REL for e in errs):
                fail('f32: the Function over K6 and K3 differs from the one '
                     f'over their plain versions at stride {strides[lvl]}: '
                     + ', '.join(f'{n} {e:.3e}' for e, n in zip(errs, names)))


def phase_serial_training(torch, gpu):
    from kgdet_tpu_torch.parallel.train import make_loss_fn

    n_levels = len(SERIAL_LEVELS)
    model, cfg, optimizer, batches, got = take_train_steps(
        torch, gpu, SERIAL_CONFIG, launch_counts(
            deform_sample_cols=2 * n_levels, deform_sample_bwd=2 * n_levels,
            stem_pool=1, frozen_bottleneck=3),
        n_logs=5 * n_levels + 4,
        free_name='bbox_head.keypts_refine_out.weight')
    loss_fn = make_loss_fn(model, cfg, CANVAS)

    def run(dtype, plain):
        # the prefix stays on K4 and K5 on both sides: the candidate boxes,
        # and so the refine targets, are then the same
        return loss_and_grads(model, optimizer, loss_fn, SERIAL_GRAD_GROUPS,
                              dtype, plain, batches[0], same_prefix=True)

    f32 = torch.float32
    phase_serial_function(torch, model, loss_fn, batches[0])
    ref_loss, ref = head32 = run(f32, True)
    check_same_prefix_grads('K6+K3', run(f32, False), head32)
    plain16 = run(torch.bfloat16, True)
    check_bf16_grads(ref_loss, ref, run(torch.bfloat16, False), plain16,
                     SERIAL_GRAD_GROUPS)
    optimizer.zero_grad()
    model.dtype = torch.bfloat16
    return model, cfg, optimizer, batches[0], got


def phase_per_block_backbone(torch, model, req, gpu):
    """The backbone with the frozen layer1 run block by block (K8) in place
    of the K4+K5 chain: launch counts, the C2 output against the chain's and
    against the all-plain route's in f32 and bf16, the chain's own bf16
    error, and the frozen prefix's time on both routes. And what each route
    puts on the device once its weights are kept: the per-block route K8's
    16x16 tensor-core body x3 beside PyTorch's stem, the served chain K4 and
    K5 x3 and nothing else."""
    from kgdet_tpu_torch.ops import plain_kernels
    from kgdet_tpu_torch.ops.image import device_normalize

    backbone = model.backbone
    image = device_normalize(torch.as_tensor(req['image']).cuda(),
                             torch.as_tensor(req['img_hw']).cuda())

    def c2(dtype, per_block, plain):
        backbone.prefix_pipeline = not per_block
        with torch.inference_mode(), plain_kernels(plain):
            return backbone(image.to(dtype))[0]

    try:
        reset_launches()
        k16 = c2(torch.bfloat16, True, False)
        got = read_launches()
        want = launch_counts(fused_bottleneck=3, bn_epilogue=R50_EPILOGUES)
        if got != want:
            fail(f'per-block backbone: launch counts {got} != {want}')
        ref = c2(torch.float32, True, True)
        scale = ref.abs().max().item()
        e_chain = max_err(c2(torch.float32, True, False),
                          c2(torch.float32, False, False))
        e_plain = max_err(c2(torch.float32, True, False), ref)
        ek, ep = max_err(k16, ref), max_err(c2(torch.bfloat16, True, True),
                                            ref)
        ec = max_err(c2(torch.bfloat16, False, False), ref)
        epc = max_err(c2(torch.bfloat16, False, True), ref)
        x16 = image.to(torch.bfloat16)
        times = {}
        for per_block in (False, True, True, False):
            backbone.prefix_pipeline = not per_block
            times.setdefault(per_block, []).append(
                median_ms(lambda: backbone.frozen_prefix(x16), reps=10))
        with torch.inference_mode():
            backbone.prefix_pipeline = False
            pb_names = {}
            pb_ms, pb_dev, pb_own = device_profile(
                lambda: backbone.frozen_prefix(x16), names=pb_names)
            backbone.prefix_pipeline = True
            chain_names = {}
            prefix_ms, n_dev, n_own = device_profile(
                lambda: backbone.frozen_prefix(x16), names=chain_names)
    finally:
        backbone.prefix_pipeline = True
    print(f'per-block backbone (K8 x3, stem and maxpool by PyTorch), C2 of '
          f'{tuple(k16.shape)}: f32 vs the K4+K5 chain {e_chain:.3e}, vs the '
          f'all-plain route {e_plain:.3e} (bound {MODEL_F32_REL * scale:.3e});'
          f' bf16 vs f32 plain: K8 route {ek:.3e}, plain route {ep:.3e}, '
          f'chain {ec:.3e}, plain chain {epc:.3e} (bound {BF16_RATIO} x '
          f'plain); frozen prefix bf16 median ms: per block '
          f'{min(times[True]):.4f}, chain {min(times[False]):.4f}; on '
          f'their kept weights, a forward puts on the device: per block '
          f'{pb_dev:g} activities, {pb_names["device_ms"]:.4f} ms, of '
          f'which K8 {pb_own:g} launches, {pb_ms:.4f} ms ({pb_names["own"]});'
          f' chain {n_dev:g} activities, {chain_names["device_ms"]:.4f} ms, '
          f'of '
          f'which the port\'s kernels {n_own:g}, {prefix_ms:.4f} ms '
          f'({gpu})', flush=True)
    if not max(e_chain, e_plain) <= MODEL_F32_REL * scale:
        fail('f32: the per-block backbone differs from the chain or the '
             'plain route')
    if not ek <= BF16_RATIO * ep:
        fail(f'bf16: per-block backbone err {ek:.3e} > {BF16_RATIO} x plain '
             f'{ep:.3e}')
    if not ec <= BF16_RATIO * epc:
        fail(f'bf16: K4+K5 chain err {ec:.3e} > {BF16_RATIO} x the plain '
             f'chain\'s {epc:.3e}')
    if pb_own != 3 or not all(re.search(r'bottleneck_mma_kernel<16, ?16>', n)
                              for n in pb_names['own']):
        fail(f'the per-block frozen prefix ran {pb_names["own"]} x '
             f'{pb_own:g}, not K8\'s 16x16 tensor-core body x3')
    if n_dev != 4 or n_own != 4:
        fail(f'the served frozen prefix put {n_dev:g} activities on the '
             f'device, {n_own:g} of them the port\'s kernels, not K4 and K5 '
             f'x3 alone')
    return got


TRAIN_STAGES = ('normalize', 'fwd_backbone', 'fwd_neck', 'fwd_head',
                'loss_targets', 'backward', 'optimizer')


def phase_train_profile(torch, model, cfg, optimizer, batch, gpu, steps=2,
                        canvas=CANVAS):
    """The train step by stage, on ``batch`` padded to ``canvas``. Each
    stage ends in a synchronize inside its
    labelled range, so every kernel falls into the host range of its stage
    (the backward's kernels are launched from the autograd thread): per
    stage the host span (launch overhead included) and the device busy time.
    The idle share of a step is taken against an unprofiled, unsynchronized
    run of the same stages."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from kgdet_tpu_torch.ops.image import device_normalize
    from kgdet_tpu_torch.parallel.train import (
        BATCH_KEYS, batch_valid_flags, build_level_geometry, compute_loss)

    feed = {k: torch.as_tensor(batch[k]).cuda() for k in BATCH_KEYS}
    grids = build_level_geometry(cfg, canvas, device='cuda')

    stage = record_function

    def run(sync):
        optimizer.zero_grad()
        with stage('normalize'):
            x = device_normalize(feed['image'], feed['valid_hw'])
            sync()
        with stage('fwd_backbone'):
            feats = model.backbone(x.to(model.dtype))
            sync()
        with stage('fwd_neck'):
            if model.neck is not None:      # SSD300: the Identity neck
                feats = model.neck(feats)
            sync()
        with stage('fwd_head'):
            outs = model.bbox_head(feats)
            sync()
        with stage('loss_targets'):
            valids = batch_valid_flags(cfg, canvas, feed['valid_hw'])
            total, _ = compute_loss(outs, grids, valids, feed, cfg,
                                    canvas_hw=canvas)
            sync()
        with stage('backward'):
            total.backward()
            sync()
        with stage('optimizer'):
            optimizer.step()
            sync()

    run(torch.cuda.synchronize)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run(lambda: None)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # short spin kernels, not counted, at the recording's edges, where
        # device records get lost (device_profile)
        for _ in range(4):
            torch.cuda._sleep(1000)
        for _ in range(steps):
            run(torch.cuda.synchronize)
        for _ in range(4):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    span_ms, busy_ms, kern = stage_times(prof, TRAIN_STAGES, DeviceType.CPU,
                                         steps)
    busy = sum(busy_ms.values())
    if busy <= 0:
        fail('the profiler saw no device time in the train step')
    print(f'train profile: {steps} steps of {len(feed["image"])} at '
          f'{canvas[0]}x{canvas[1]}: {wall:.3f} ms per step '
          f'unprofiled, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.3f} ({gpu})', flush=True)
    print('  stage host span (synchronized) / device busy ms per step: '
          + ', '.join(f'{s} {span_ms[s]:.3f}/{busy_ms[s]:.3f}'
                      for s in TRAIN_STAGES + ('other',)), flush=True)
    print_top_kernels(kern, steps, 10)
    print_own_kernels(kern, steps, 'step')


# ------------------------------------------------------------ phase 9: eval
# 24 batches of 8, 12 on each canvas: a window of inference and evaluation
# long enough that setup and the first calls do not set the rate
EVAL_IMAGES = 192
# (height, width) of the landscape images, in turn; the portrait ones are
# these transposed. One in eight is exactly the 1333 x 800 scale, the rest
# need a resize. The first 16 images hold every size in both orientations
EVAL_SIZES = ((800, 1333), (600, 900), (480, 640), (720, 1280),
              (1000, 1500), (375, 500), (768, 1024), (900, 1200))
# two landscape and two portrait images, batches of 2 (the grouped loader,
# as the JAX package's, cannot wrap-pad a group of fewer than half a batch)
TTA_IMAGES = 4
# the configured scale, half of it (inside the canvas buckets) and one
# beyond every bucket (its canvas and predict function made on first use)
TTA_SCALES = ('1333', '800', '667', '400', '1600', '960')


def make_eval_set(root, seed, n_images=EVAL_IMAGES, split='validation',
                  sizes=EVAL_SIZES):
    """A DeepFashion2-style set under ``root``: {split}-coco_style.json and
    {split}/image/*.png, ``n_images`` images (half landscape, half
    portrait, ``sizes``), 1 to 3 garments an
    image with keypoints in their class's slice of the 294 and
    num_keypoints, and a crowd region in every fourth image. The images are
    smooth colour ramps with the garments as flat boxes and a little
    noise."""
    import numpy as np

    from kgdet_tpu_torch.data.deepfashion2_meta import (
        CLASS_KEYPOINT_RANGES, NUM_KEYPOINTS)
    from kgdet_tpu_torch.data.image_io import write_png

    rng = np.random.RandomState(seed)
    img_dir = os.path.join(root, split, 'image')
    os.makedirs(img_dir)
    images, anns = [], []
    for i in range(n_images):
        h, w = sizes[i // 2 % len(sizes)]
        if i % 2:
            h, w = w, h
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 255 // w, yy * 255 // h,
                        (xx + yy) * 255 // (h + w)], -1).astype(np.int32)
        name = f'{i + 1:06d}.png'
        images.append({'id': i + 1, 'file_name': name, 'height': h,
                       'width': w})
        for _ in range(rng.randint(1, 4)):
            bw, bh = rng.randint(w // 6, w // 2), rng.randint(h // 6, h // 2)
            x0, y0 = rng.randint(0, w - bw), rng.randint(0, h - bh)
            img[y0:y0 + bh, x0:x0 + bw] = rng.randint(0, 256, 3)
            cat = int(rng.randint(1, 14))
            s, e = CLASS_KEYPOINT_RANGES[cat]
            kp = np.zeros((NUM_KEYPOINTS, 3))
            kp[s:e, 0] = rng.uniform(x0, x0 + bw, e - s).round(1)
            kp[s:e, 1] = rng.uniform(y0, y0 + bh, e - s).round(1)
            kp[s:e, 2] = rng.choice([0, 1, 2], e - s, p=[0.2, 0.4, 0.4])
            anns.append({'id': len(anns) + 1, 'image_id': i + 1,
                         'category_id': cat, 'iscrowd': 0,
                         'bbox': [float(x0), float(y0), float(bw),
                                  float(bh)], 'area': float(bw * bh),
                         'keypoints': kp.reshape(-1).tolist(),
                         'num_keypoints': int((kp[:, 2] > 0).sum())})
        if i % 4 == 0:
            anns.append({'id': len(anns) + 1, 'image_id': i + 1,
                         'category_id': int(rng.randint(1, 14)),
                         'iscrowd': 1, 'bbox': [0.0, 0.0, w / 4, h / 4],
                         'area': w * h / 16, 'num_keypoints': 0,
                         'keypoints': [0.0] * 3 * NUM_KEYPOINTS})
        img += rng.randint(-4, 5, img.shape)
        write_png(os.path.join(img_dir, name),
                  np.clip(img, 0, 255).astype(np.uint8))
    cats = [{'id': c, 'name': f'cls{c}'} for c in range(1, 14)]
    with open(os.path.join(root, f'{split}-coco_style.json'), 'w') as f:
        json.dump({'images': images, 'annotations': anns,
                   'categories': cats}, f)
    return images, anns


def eval_config(root, name):
    """CONFIG with its data root at ``root`` and test.score_thr 0.0 (so the
    evaluation has detections to score under random weights)."""
    with open(CONFIG) as f:
        text = f.read()
    if "_DATA_ROOT = '/data/deepfashion2'" not in text:
        fail('the cascade config no longer sets _DATA_ROOT')
    text = text.replace("_DATA_ROOT = '/data/deepfashion2'",
                        f'_DATA_ROOT = {root!r}')
    text += ('\nimport dataclasses\nconfig = config.replace(test='
             'dataclasses.replace(config.test, score_thr=0.0))\n')
    path = os.path.join(root, name)
    with open(path, 'w') as f:
        f.write(text)
    return path


def run_cli(argv):
    """tools/test.py's main in this process; returns its result and what
    it printed (echoed here)."""
    import contextlib
    import io

    from kgdet_tpu_torch.tools import test as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = cli.main(argv)
    print(buf.getvalue(), end='', flush=True)
    return out, buf.getvalue()


def copypaste(printed, iou_type, n):
    import math
    lines = [ln for ln in printed.splitlines()
             if ln.startswith(f'{iou_type}_mAP_copypaste: ')]
    if len(lines) != 1:
        fail(f'{len(lines)} {iou_type}_mAP_copypaste lines')
    vals = [float(v) for v in lines[0].split(': ', 1)[1].split()]
    if len(vals) != n or not all(math.isfinite(v) for v in vals):
        fail(f'{iou_type}_mAP_copypaste: {vals}, want {n} finite numbers')
    return vals


def phase_eval(torch, gpu, per_fwd):
    """The evaluation path at full width: a synthetic DeepFashion2-style
    validation set as PNGs, the evaluator on its own ground truth, the
    model on its kernels against on their plain versions at batch 8 on both
    canvases, the CLI tools/test.py in-process (launch counts per batch,
    both JSON files, the copypaste lines), run_inference against a direct
    predict call, and multi-scale / flip TTA on a subset."""
    import shutil
    import tempfile

    import numpy as np

    from kgdet_tpu_torch.api import init_detector, make_predict_fn
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.data import image_io
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.data.loader import DataLoader
    from kgdet_tpu_torch.eval_loop import evaluate_results, run_inference

    root = tempfile.mkdtemp(prefix='kgdet_eval_')
    try:
        t0 = time.perf_counter()
        images, anns = make_eval_set(root, SEED)
        cfg_path = eval_config(root, 'eval_cfg.py')
        cfg = load_config(cfg_path)
        data = cfg.val_data
        print(f'eval: {len(images)} PNG images '
              f'({sum(im["width"] > im["height"] for im in images)} '
              f'landscape), {len(anns)} annotations '
              f'({sum(a["iscrowd"] for a in anns)} crowd) written in '
              f'{time.perf_counter() - t0:.1f} s; image_io backend '
              f'{image_io.BACKEND}; val_data batch {data.batch_size}, '
              f'canvases {data.canvas_hw}, img_scale {data.img_scale}; '
              f'test.score_thr set to 0.0', flush=True)
        dataset = DeepFashion2Dataset(data, train=False)

        # the evaluator on its own ground truth: all-area AP 1
        gt = {}
        for a in anns:
            if a['iscrowd']:
                continue
            x, y, w, h = a['bbox']
            gt.setdefault(a['image_id'], []).append(
                ([x, y, x + w - 1, y + h - 1, 1.0],
                 dataset.cat_ids.index(a['category_id']), a['keypoints']))
        results = {i: (np.asarray([g[0] for g in v], np.float32),
                       np.asarray([g[1] for g in v]),
                       np.asarray([g[2] for g in v], np.float32))
                   for i, v in gt.items()}
        stats, _ = evaluate_results(results, dataset,
                                    os.path.join(root, 'gt'), verbose=False)
        print(f'eval: ground truth as detections, all-area AP bbox '
              f'{stats["bbox"]["AP"]:.4f}, keypoints '
              f'{stats["keypoints"]["AP"]:.4f}', flush=True)
        for k in ('bbox', 'keypoints'):
            if stats[k]['AP'] != 1.0:
                fail(f'ground truth as detections: {k} AP {stats[k]}')

        # host data alone: read, resize, pad, collate, one thread; the
        # first batch of each canvas kept
        t0 = time.perf_counter()
        firsts, n_batches_data = {}, 0
        for batch in DataLoader(dataset, data.batch_size, train=False,
                                num_workers=0):
            firsts.setdefault(tuple(batch['image'].shape[1:3]), batch)
            n_batches_data += 1
        data_ms = 1e3 * (time.perf_counter() - t0) / n_batches_data
        if sorted(firsts) != sorted(map(tuple, data.canvas_hw)):
            fail(f'batch canvases {sorted(firsts)}, want both of '
                 f'{data.canvas_hw}')
        img_ms = own_ms = 1e3 * (time.perf_counter() - t0) / len(dataset)
        if image_io.cv2 is not None:
            # the port's own PNG reader and resize (what runs where OpenCV
            # is absent) on the first 16 images, every size in both
            # orientations: the same samples, bit for bit
            n = min(16, len(dataset))
            t0 = time.perf_counter()
            ref = [dataset.prepare_test(i) for i in range(n)]
            img_ms = 1e3 * (time.perf_counter() - t0) / n
            opencv, image_io.cv2 = image_io.cv2, None
            try:
                t0 = time.perf_counter()
                own = [dataset.prepare_test(i) for i in range(n)]
                own_ms = 1e3 * (time.perf_counter() - t0) / n
            finally:
                image_io.cv2 = opencv
            for i, (a, b) in enumerate(zip(ref, own)):
                for k in a:
                    if not np.array_equal(a[k], b[k]):
                        fail(f'the NumPy image path differs from cv2 '
                             f'{opencv.__version__} in {k} of sample {i}')
            print(f'eval: the NumPy image path gives the samples of cv2 '
                  f'{opencv.__version__} bit for bit on {n} images; an '
                  f'image: {img_ms:.1f} ms with cv2, {own_ms:.1f} ms with '
                  f'NumPy', flush=True)

        # the model on its kernels against on their plain versions, on the
        # first batch of 8 of each canvas
        model = init_detector(cfg).model
        for (h, w), batch in sorted(firsts.items()):
            hold_against_plain(torch, model, batch,
                               f'eval batch {data.batch_size} {h}x{w}: ')

        # the CLI, in-process, on the card
        prefix = os.path.join(root, 'results')
        torch.cuda.synchronize()
        reset_launches()
        out, printed = run_cli([cfg_path, '--json-out', prefix])
        got = read_launches()
        n_batches = out['timings']['batches']
        want = {k: v * n_batches for k, v in per_fwd.items()}
        print(f'eval: CLI launches {got} over {n_batches} batches of '
              f'{data.batch_size}', flush=True)
        if n_batches != n_batches_data or got != want:
            fail(f'CLI launches {got} != {want} for {n_batches_data} '
                 f'batches')
        ids = sorted(r['id'] for r in images)
        if sorted(out['results']) != ids:
            fail('the CLI results do not hold every image once')
        for k in ('bbox', 'keypoints'):
            if not os.path.isfile(out['files'][k]):
                fail(f'{out["files"][k]} was not written')
        copypaste(printed, 'bbox', 12)
        copypaste(printed, 'keypoints', 10)
        n_dets = sum(len(r[0]) for r in out['results'].values())
        if n_dets == 0:
            fail('the CLI scored no detection')

        # the loop adds nothing: run_inference's detections of a batch are
        # the predict function's, cut by valid
        canvas, first = next(iter(firsts.items()))
        dets = make_predict_fn(model, cfg, canvas)(first)
        timings = {}
        loop = run_inference(model, cfg, DataLoader(
            dataset, data.batch_size, train=False), verbose=False,
            timings=timings)
        for i, img_id in enumerate(first['img_id'].tolist()):
            v = dets['valid'][i].cpu().numpy()
            direct = [dets[k][i].cpu().numpy()[v]
                      for k in ('det_bboxes', 'det_labels', 'det_kpts')]
            for a, b in zip(loop[img_id], direct):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    fail(f'run_inference differs from the predict call on '
                         f'image {img_id}')
        print(f'eval: run_inference bit-equal to make_predict_fn on the '
              f'{len(first["img_id"])} images of the first batch', flush=True)
        phase_profile(torch, model, cfg, first, gpu)
        del model
        torch.cuda.empty_cache()

        # multi-scale / flip TTA on a subset
        with open(os.path.join(root, 'validation-coco_style.json')) as f:
            coco = json.load(f)
        keep = {im['id'] for im in coco['images'][:TTA_IMAGES]}
        coco['images'] = [im for im in coco['images'] if im['id'] in keep]
        coco['annotations'] = [a for a in coco['annotations']
                               if a['image_id'] in keep]
        with open(os.path.join(root, 'subset.json'), 'w') as f:
            json.dump(coco, f)
        tta_cfg = eval_config(root, 'tta_cfg.py')
        with open(tta_cfg, 'a') as f:
            f.write("config = config.replace(val_data=dataclasses.replace("
                    "config.val_data, ann_file=_DATA_ROOT + "
                    "'/subset.json'))\n")
        t0 = time.perf_counter()
        reset_launches()
        tta, printed = run_cli([tta_cfg, '--aug', '--aug-scales',
                                *TTA_SCALES, '--batch-size', '2',
                                '--json-out', os.path.join(root, 'tta')])
        tta_s = time.perf_counter() - t0
        copypaste(printed, 'bbox', 12)
        if sorted(tta['results']) != sorted(keep):
            fail('TTA results do not hold every image of the subset once')
        subset = DeepFashion2Dataset(load_config(tta_cfg).val_data,
                                     train=False)
        # each (long, short) pair of TTA_SCALES plain and flipped
        variants = len(TTA_SCALES) // 2 * 2
        tta_batches = variants * len(DataLoader(subset, 2, train=False))
        want = {k: v * tta_batches for k, v in per_fwd.items()}
        want['greedy_nms'] = len(subset)    # one NMS an image, merged
        if read_launches() != want:
            fail(f'TTA launches {read_launches()} != {want} for '
                 f'{tta_batches} batches')
        print(f'eval: TTA over {TTA_IMAGES} images, batch 2, at scales '
              f'{" ".join(TTA_SCALES)} with flips: {tta_s:.1f} s, '
              f'{tta_batches} batches, launches {read_launches()}',
              flush=True)

        t = out['timings']
        n = t['images']
        cli_ms = 1e3 * t['predict_s'] / n_batches
        print(f'eval: {len(images)} images in {n_batches} batches '
              f'({n} with the wrap-padding); host data '
              f'{data_ms:.1f} ms a batch (read, resize, pad, collate; one '
              f'thread, {image_io.BACKEND}; an image {img_ms:.1f} ms, '
              f'{own_ms:.1f} with NumPy); predict '
              f'{1e3 * timings["predict_s"] / timings["batches"]:.1f} ms a '
              f'batch (warm; the CLI run {cli_ms:.1f} with the first '
              f'calls), waiting for data '
              f'{1e3 * t["data_s"] / n_batches:.1f} ms a batch; CLI wall '
              f'{t["wall_s"]:.2f} s (setup '
              f'{t["setup_s"]:.2f}, inference {t["infer_s"]:.2f}, '
              f'evaluation {t["eval_s"]:.2f}): inference '
              f'{len(images) / t["infer_s"]:.2f} img/s, evaluation '
              f'{len(images) / t["eval_s"]:.2f} img/s, wall '
              f'{len(images) / t["wall_s"]:.2f} img/s ({gpu})', flush=True)
        return got
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------ phase 10: training
# 64 landscape and 64 portrait images: 16 steps of the shipped batch of 8
# an epoch, 8 on each canvas; 64 validation images: 8 batches of 8
TRAIN_IMAGES = 128
VAL_IMAGES = 64
TRAIN_LOG_INTERVAL = 4
# run 1 trains epoch 1; run 2 resumes, trains epoch 2 and validates
TRAIN_EPOCHS = 2
# the loop's rate: a run of its own on the training PNGs listed this many
# times (64 steps an epoch), read over its second epoch after the first
# interval. In a 16-step epoch no window is steady: the loader refills at
# the epoch's start and has its queue full before the end (one run on an
# H100 read 30.73, 55.71, 65.97, 93.37 img/s by interval of epoch 3)
LOOP_REPEAT = 4
# timed steps of the step alone on each canvas, after two warm ones
STEP_ALONE = 8


def run_train_cli(argv, eval_launches=None):
    """tools/train.py's main in this process; returns the runner and what
    it printed (echoed here). With ``eval_launches`` (a list), each
    Runner.evaluate of the run appends the launches it made."""
    import contextlib
    import io

    from kgdet_tpu_torch.runner import Runner
    from kgdet_tpu_torch.tools import train as cli
    evaluate = Runner.evaluate

    def counted(self, *a, **kw):
        before = read_launches()
        out = evaluate(self, *a, **kw)
        after = read_launches()
        eval_launches.append({k: after[k] - before[k] for k in after})
        return out
    if eval_launches is not None:
        Runner.evaluate = counted
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runner = cli.main(argv)
    finally:
        Runner.evaluate = evaluate
        print(buf.getvalue(), end='', flush=True)
    return runner, buf.getvalue()


def repeat_train_set(root, times):
    """A config on the training set under ``root`` with every image listed
    ``times`` times (new image and annotation ids, the same files)."""
    with open(os.path.join(root, 'train-coco_style.json')) as f:
        coco = json.load(f)
    n, m = len(coco['images']), len(coco['annotations'])
    coco['images'] = [dict(im, id=r * n + im['id'])
                      for r in range(times) for im in coco['images']]
    coco['annotations'] = [dict(a, id=r * m + a['id'],
                                image_id=r * n + a['image_id'])
                           for r in range(times)
                           for a in coco['annotations']]
    with open(os.path.join(root, 'train_long-coco_style.json'), 'w') as f:
        json.dump(coco, f)
    path = eval_config(root, 'long_cfg.py')
    with open(path, 'a') as f:
        f.write("config = config.replace(train_data=dataclasses.replace("
                "config.train_data, ann_file=_DATA_ROOT + "
                "'/train_long-coco_style.json'))\n")
    return path


def loop_rates(recs, epoch, imgs):
    """The img/s of each log interval of ``epoch`` (1-based) as the runner
    recorded it (synchronized at the interval's end, nowhere else), the
    rate over the whole epoch and over all its intervals but the first
    (which holds the loader's refill)."""
    rates = [r['imgs_per_sec'] for r in recs
             if r['mode'] == 'train' and r['epoch'] == epoch]
    secs = [imgs / r for r in rates]
    return rates, len(rates) * imgs / sum(secs), \
        (len(rates) - 1) * imgs / sum(secs[1:])


def loader_rates(loader, epoch, skip):
    """The training loader alone (its threads, no step) over ``epoch``:
    img/s over the whole epoch and after its first ``skip`` batches."""
    loader.set_epoch(epoch)
    t = [time.perf_counter()]
    for _ in loader:
        t.append(time.perf_counter())
    n, bs = len(t) - 1, loader.batch_size
    return n * bs / (t[-1] - t[0]), (n - skip) * bs / (t[-1] - t[skip])


def step_alone_ms(torch, model, cfg, optimizer, batch, canvas):
    """ms a train step on a batch already on the card, over STEP_ALONE
    steps after two warm ones, synchronized before and after the timed
    steps only."""
    from kgdet_tpu_torch.parallel.train import (
        BATCH_KEYS, OPTIONAL_BATCH_KEYS, make_train_step)
    step = make_train_step(model, cfg, canvas, optimizer)
    feed = {k: torch.as_tensor(batch[k]).cuda()
            for k in BATCH_KEYS + OPTIONAL_BATCH_KEYS if k in batch}
    for _ in range(2):
        step(feed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEP_ALONE):
        step(feed)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / STEP_ALONE


def stats_line(values):
    return ' '.join(f'{v:.4f}' for v in values)


def rates_line(values):
    return ', '.join(f'{v:.2f}' for v in values)


def phase_train_loop(torch, gpu, per_step, per_eval):
    """The training loop at full width on the cascade config, train_data
    as shipped (batch 8, flip_ratio 0.5, canvases 800x1344 and 1344x800):
    tools/train.py for one epoch; again with --resume and --max-epochs 1,
    which restores and trains nothing (the resume exact in state, step,
    epoch, learning rate and batch order); again with --resume for epoch
    2 and --validate; finite logs; launches per step and per
    evaluation batch; the frozen prefix bit-equal and a free parameter
    moved; tools/test.py --checkpoint equal to the runner's last
    evaluation; K2+K3 against their plain versions on a step's tensors at
    batch 8 on both canvases; the loop's rate over a long epoch against
    the loader's and the step's alone; the step by stage at batch 8 on both canvases. Returns
    (launches in training, launches in evaluation)."""
    import math
    import shutil
    import tempfile

    import numpy as np

    from kgdet_tpu_torch.api import build_model, make_predict_fn
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.data.loader import DataLoader, grouped_batch_indices
    from kgdet_tpu_torch.parallel.train import (make_loss_fn,
                                                make_lr_schedule)
    from kgdet_tpu_torch.utils.checkpoint import FILE, load_params

    root = tempfile.mkdtemp(prefix='kgdet_train_')
    try:
        t0 = time.perf_counter()
        make_eval_set(root, SEED + 10, n_images=TRAIN_IMAGES, split='train')
        make_eval_set(root, SEED + 11, n_images=VAL_IMAGES)
        cfg_path = eval_config(root, 'train_cfg.py')
        cfg = load_config(cfg_path)
        data = cfg.train_data
        print(f'train loop: {TRAIN_IMAGES} training and {VAL_IMAGES} '
              f'validation PNGs written in {time.perf_counter() - t0:.1f} s; '
              f'train_data batch {data.batch_size}, flip_ratio '
              f'{data.flip_ratio}, canvases {data.canvas_hw}; '
              f'{cfg.compute_dtype}; optimizer {cfg.optim.type} lr '
              f'{cfg.optim.lr} warmup {cfg.optim.warmup_iters}', flush=True)
        work = os.path.join(root, 'work')
        args = [cfg_path, '--work-dir', work,
                '--log-interval', str(TRAIN_LOG_INTERVAL)]

        # run 1: one epoch
        reset_launches()
        runner1, _ = run_train_cli(args + ['--max-epochs', '1'])
        train_launches = read_launches()
        spe = runner1.steps_per_epoch
        if spe != TRAIN_IMAGES // data.batch_size or runner1.step != spe:
            fail(f'run 1: {runner1.step} steps, {spe} an epoch')
        step1 = os.path.join(work, 'checkpoints', str(spe))
        saved = load_params(step1)
        saved_opt = torch.load(os.path.join(step1, FILE),
                               weights_only=True)['optimizer']

        # the resume alone: --resume --max-epochs 1 restores step 16 and
        # trains nothing; its state, step, epoch, learning rate, batches
        resumed, _ = run_train_cli(args + ['--resume', '--max-epochs', '1'])
        if (resumed.step, resumed.epoch) != (spe, 1):
            fail(f'the resume is at step {resumed.step}, epoch '
                 f'{resumed.epoch}, not {spe}, 1')
        live = runner1.model.state_dict()
        restored = resumed.model.state_dict()
        for k, v in restored.items():
            if not (torch.equal(v.cpu(), saved[k])
                    and torch.equal(v, live[k])):
                fail(f'the resume restored {k} differently from what run 1 '
                     'saved')
        opt = resumed.optimizer.state_dict()
        opt1 = runner1.optimizer.state_dict()
        if opt['step_count'] != spe or saved_opt['step_count'] != spe:
            fail(f'optimizer step_count {opt["step_count"]} after the '
                 f'resume, {saved_opt["step_count"]} saved')
        for k, v in opt['momentum'].items():
            if not (torch.equal(v.cpu(), saved_opt['momentum'][k])
                    and torch.equal(v, opt1['momentum'][k])):
                fail(f'the resume restored the momentum of {k} differently')
        want_lr = make_lr_schedule(cfg, spe)(spe)
        first_lr = resumed.optimizer.schedule(opt['step_count'])
        if first_lr != want_lr:
            fail(f'the resumed optimizer steps at lr {first_lr}, not '
                 f'schedule({spe}) = {want_lr}')
        resumed.train_loader.set_epoch(resumed.epoch)
        got = resumed.train_loader._epoch_batches()[0]
        runner1.train_loader.set_epoch(1)
        uninterrupted = runner1.train_loader._epoch_batches()[0]
        drawn = grouped_batch_indices(resumed.train_dataset.flags,
                                      data.batch_size, 1, cfg.seed)[0]
        if not (np.array_equal(got, uninterrupted)
                and np.array_equal(got, drawn)):
            fail(f'the resume draws {got} first, an uninterrupted run '
                 f'{uninterrupted}')
        print(f'train loop: the resume is at step {resumed.step}, epoch '
              f'{resumed.epoch}; {len(restored)} tensors of the model and '
              f'{len(opt["momentum"])} momentum buffers bit-equal to what '
              f'run 1 saved and held; first lr schedule({spe}) = '
              f'{first_lr:g}; first batch of epoch 2 {got.tolist()}, as an '
              f'uninterrupted run draws it', flush=True)
        del resumed, restored, opt

        # run 2: --resume, epochs 2 and 3, --validate after each
        evals = []
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        runner2, printed = run_train_cli(
            args + ['--resume', '--max-epochs', str(TRAIN_EPOCHS),
                    '--validate'], evals)
        peak = torch.cuda.max_memory_allocated()
        total = read_launches()
        if runner2.step != TRAIN_EPOCHS * spe or \
                f'resumed from step {spe} (epoch 1)' not in printed:
            fail(f'run 2 did not resume at step {spe} and end at '
                 f'{TRAIN_EPOCHS * spe} (step {runner2.step})')
        for k in total:
            train_launches[k] += total[k] - sum(e[k] for e in evals)

        # logs, launches, frozen and free parameters
        with open(os.path.join(work, 'train_log.jsonl')) as f:
            recs = [json.loads(line) for line in f]
        train_recs = [r for r in recs if r['mode'] == 'train']
        val_recs = [r for r in recs if r['mode'] == 'val']
        if len(train_recs) != TRAIN_EPOCHS * spe // TRAIN_LOG_INTERVAL or \
                len(val_recs) != TRAIN_EPOCHS - 1:
            fail(f'{len(train_recs)} train and {len(val_recs)} val records')
        for r in recs:
            vals = [v for v in r.values() if not isinstance(v, str)]
            if not all(math.isfinite(v) for v in vals):
                fail(f'a non-finite log record: {r}')
        first2 = train_recs[spe // TRAIN_LOG_INTERVAL]
        want_lr2 = make_lr_schedule(cfg, spe)(spe + TRAIN_LOG_INTERVAL - 1)
        if (first2['epoch'], first2['iter'], first2['lr']) != \
                (2, TRAIN_LOG_INTERVAL, want_lr2):
            fail(f'run 2 first logged {first2}, not epoch 2 iter '
                 f'{TRAIN_LOG_INTERVAL} at lr {want_lr2}')
        for r in train_recs:
            print(f'  log epoch {r["epoch"]} iter {r["iter"]}: lr '
                  f'{r["lr"]:.6f} loss {r["loss"]:.4f} grad_norm '
                  f'{r["grad_norm"]:.4f} num_pos {r["num_pos"]:.1f} '
                  f'img/s {r["imgs_per_sec"]:.2f}', flush=True)
        n_val = len(DataLoader(DeepFashion2Dataset(cfg.val_data,
                                                   train=False),
                               cfg.val_data.batch_size, train=False))
        want_train = {k: v * TRAIN_EPOCHS * spe for k, v in per_step.items()}
        want_eval = {k: v * n_val for k, v in per_eval.items()}
        print(f'train loop: launches {train_launches} over '
              f'{TRAIN_EPOCHS * spe} steps, {evals} over the {n_val} '
              f'batches of each --validate', flush=True)
        if train_launches != want_train or len(evals) != TRAIN_EPOCHS - 1 \
                or any(e != want_eval for e in evals):
            fail(f'train loop launches {train_launches} / {evals} != '
                 f'{want_train} / {want_eval} each')
        init = build_model(cfg, device='cpu').init_weights(cfg.seed) \
            .state_dict()
        final = runner2.model.state_dict()
        for k in ('backbone.conv1.weight', 'backbone.layer1.0.conv1.weight',
                  'backbone.layer1.2.bn3.running_var'):
            if not torch.equal(final[k].cpu(), init[k]):
                fail(f'frozen {k} changed in training')
        free = 'bbox_head.kp_rep_block_3.cls_out.weight'
        if torch.equal(final[free].cpu(), init[free]):
            fail(f'free parameter {free} did not move')

        # tools/test.py --checkpoint: the runner's last evaluation, and the
        # runner model's detections on the first batch, bit for bit
        last = TRAIN_EPOCHS * spe
        step_dir = os.path.join(work, 'checkpoints', str(last))
        reset_launches()
        out, cli_printed = run_cli([cfg_path, '--checkpoint', step_dir,
                                    '--json-out',
                                    os.path.join(root, 'ckpt_eval')])
        cli_launches = read_launches()
        if cli_launches != want_eval:
            fail(f'--checkpoint launches {cli_launches} != {want_eval}')
        eval_launches = {k: sum(e[k] for e in evals) + v
                         for k, v in cli_launches.items()}
        for iou_type, s in out['stats'].items():
            rec = {k: val_recs[-1][f'{iou_type}_{k}'] for k in s}
            if rec != {k: float(v) for k, v in s.items()}:
                fail(f'--checkpoint {iou_type} stats {s} != the runner\'s '
                     f'{rec}')
            cli = copypaste(cli_printed, iou_type, len(s))
            line = [ln for ln in printed.splitlines() if ln.startswith(
                f'Epoch [{TRAIN_EPOCHS}] {iou_type}_mAP_copypaste: ')]
            if len(line) != 1 or line[0].split(': ', 1)[1] != \
                    stats_line(cli[:3]):
                fail(f'{iou_type}: --validate printed {line}, --checkpoint '
                     f'{stats_line(cli)}')
        val_ds = DeepFashion2Dataset(cfg.val_data, train=False)
        first_batch = next(iter(DataLoader(val_ds, cfg.val_data.batch_size,
                                           train=False, num_workers=0)))
        canvas = tuple(first_batch['image'].shape[1:3])
        runner2.model.eval()
        dets = make_predict_fn(runner2.model, cfg, canvas)(first_batch)
        for i, img_id in enumerate(first_batch['img_id'].tolist()):
            v = dets['valid'][i].cpu().numpy()
            direct = [dets[k][i].cpu().numpy()[v]
                      for k in ('det_bboxes', 'det_labels', 'det_kpts')]
            for a, b in zip(out['results'][img_id], direct):
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    fail(f'--checkpoint detections differ from the runner '
                         f'model\'s on image {img_id}')
        print(f'train loop: tools/test.py --checkpoint {last}: the stats of '
              f'the last --validate ({len(out["stats"]["bbox"])} bbox, '
              f'{len(out["stats"]["keypoints"])} keypoints), its copypaste '
              f'lines, and the runner model\'s detections on the '
              f'{len(first_batch["img_id"])} images of the first batch bit '
              f'for bit; launches {cli_launches}', flush=True)

        # the checkpoint: its size, a save of the final state (the last
        # step written again with the same state) and a restore of it
        size = os.path.getsize(os.path.join(step_dir, FILE))
        t0 = time.perf_counter()
        runner2.save_checkpoint()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        runner2.ckpt.restore(last)
        restore_s = time.perf_counter() - t0

        # host data alone on one thread, and the first batch of each canvas
        train_ds = runner2.train_dataset
        t0 = time.perf_counter()
        firsts, n_host = {}, 0
        for batch in DataLoader(train_ds, data.batch_size, train=True,
                                seed=cfg.seed, num_workers=0):
            firsts.setdefault(tuple(batch['image'].shape[1:3]), batch)
            n_host += 1
            if n_host >= 4 and len(firsts) == 2:
                break
        host_ms = 1e3 * (time.perf_counter() - t0) / n_host

        # K2+K3 against their plain versions on a step's tensors, batch 8,
        # each canvas
        model = runner2.model.train()
        for c, batch in sorted(firsts.items()):
            phase_function(torch, model, make_loss_fn(model, cfg, c), batch)
            model.dtype = torch.bfloat16

        # the loop's rate over a long epoch: a run of its own on the
        # training PNGs listed LOOP_REPEAT times, two epochs, no
        # --validate, from the runner's own records over epoch 2 after its
        # first interval (which holds the loader's refill); beside it the
        # loader alone (its threads, no step) over the same epoch after as
        # many batches, and the step alone after two warm ones
        del runner1
        reset_launches()
        runner3, _ = run_train_cli([
            repeat_train_set(root, LOOP_REPEAT), '--work-dir',
            os.path.join(root, 'work_long'), '--log-interval',
            str(TRAIN_LOG_INTERVAL), '--max-epochs', '2'])
        spe3 = runner3.steps_per_epoch
        want_long = {k: v * 2 * spe3 for k, v in per_step.items()}
        if spe3 != LOOP_REPEAT * spe or read_launches() != want_long:
            fail(f'the long run: {spe3} steps an epoch, launches '
                 f'{read_launches()} != {want_long}')
        with open(os.path.join(root, 'work_long', 'train_log.jsonl')) as f:
            recs3 = [json.loads(line) for line in f]
        imgs = TRAIN_LOG_INTERVAL * data.batch_size
        rates, loop_all, loop = loop_rates(recs3, 2, imgs)
        loader = DataLoader(runner3.train_dataset, data.batch_size,
                            train=True, seed=cfg.seed)
        loader_all, loader_steady = loader_rates(loader, 1,
                                                 TRAIN_LOG_INTERVAL)
        del runner3
        step_ms = {c: step_alone_ms(torch, model, cfg, runner2.optimizer, b,
                                    c) for c, b in sorted(firsts.items())}
        step_rate = 1e3 * data.batch_size * len(step_ms) / \
            sum(step_ms.values())
        beyond = 1e3 * data.batch_size * (1 / loop - 1 / step_rate)
        print(f'train loop: a run of {spe3} steps an epoch, img/s by log '
              f'interval of epoch 2 (the runner synchronizing once an '
              f'interval): {rates_line(rates)}; the epoch {loop_all:.2f}, '
              f'after its first interval {loop:.2f} img/s '
              f'({1e3 * data.batch_size / loop:.2f} ms a step)', flush=True)
        print(f'train loop: the step alone on a batch on the card '
              + ', '.join(f'{h}x{w} {ms:.2f} ms' for (h, w), ms in
                          step_ms.items())
              + f' ({step_rate:.2f} img/s; {STEP_ALONE} steps each, one '
              f'synchronize); the loader alone ({loader.num_workers} '
              f'threads, no step) over epoch 2 of the long run '
              f'{loader_all:.2f} img/s, after its first '
              f'{TRAIN_LOG_INTERVAL} batches {loader_steady:.2f}; the '
              f'slower alone: '
              f'{"loader" if loader_steady < step_rate else "step"}; the '
              f'loop takes {beyond:.2f} ms a step beyond the step alone; '
              f'host data a batch of {data.batch_size}, one thread, '
              f'{host_ms:.1f} ms; peak device memory '
              f'{peak / 2 ** 30:.3f} GiB; checkpoint {size / 2 ** 20:.1f} '
              f'MiB, save {save_s:.3f} s, restore {restore_s:.3f} s '
              f'({gpu})', flush=True)

        # the step by stage
        for c, batch in sorted(firsts.items()):
            phase_train_profile(torch, model, cfg, runner2.optimizer, batch,
                                gpu, canvas=c)
        del runner2, model
        torch.cuda.empty_cache()
        return train_launches, eval_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------- phase 11: data parallel
# a global batch of 8, 4 images a rank
DP_RANKS = 2
DP_BATCH = 8
# phase 9's first 32 validation PNGs (4 batches of 8, 2 on each canvas)
# and phase 10's first 32 training PNGs (4 steps of 8)
DP_IMAGES = 32
# seconds a group of processes may take before all are killed
DP_TIMEOUT = 300


# the trainable backbone: cuDNN rounds its f32 convolutions differently at
# batch 4 and at batch 8 (the frozen prefix's K4 and K5 do not:
# backbone_batch_rounding prints both), and a ReLU pre-activation within
# that of zero falls on either side, which moves single elements of
# layer2-4's small gradients (BN biases) far more than the rounding
BATCH_ROUNDED = ('backbone.layer2.', 'backbone.layer3.', 'backbone.layer4.')


def grads_close(what, got, want, elementwise_except=()):
    """f32 gradients of a run against a reference's, by the rule of a
    whole model's gradients: all but MODEL_FLIP_SHARE of the elements
    within MODEL_F32_REL of their parameter's scale, and every element
    within MODEL_GRAD_REL of it, but in the parameters under
    ``elementwise_except`` (printed, not held)."""
    worst, worst_out, beyond, total = (0.0, ''), (0.0, ''), 0, 0
    for n, w in want.items():
        scale = w.abs().max().item()
        if scale == 0:
            continue
        diff = (got[n].float() - w).abs() / scale
        beyond += (diff > MODEL_F32_REL).sum().item()
        total += diff.numel()
        if n.startswith(elementwise_except) and elementwise_except:
            worst_out = max(worst_out, (diff.max().item(), n))
        else:
            worst = max(worst, (diff.max().item(), n))
    print(f'gradients f32, {what}: share of the elements beyond '
          f'{MODEL_F32_REL}: {beyond / total:.3e} (bound {MODEL_FLIP_SHARE});'
          f' worst element {worst[0]:.3e} of its scale ({worst[1]}; bound '
          f'{MODEL_GRAD_REL})' + (
              f'; in layer2-4 (not held) {worst_out[0]:.3e} ({worst_out[1]})'
              if elementwise_except else ''), flush=True)
    if not beyond <= MODEL_FLIP_SHARE * total or \
            not worst[0] <= MODEL_GRAD_REL:
        fail(f'f32 gradients of {what} differ beyond the bounds')


def backbone_batch_rounding(torch, cfg, state, batch):
    """The backbone's f32 outputs on the global batch at once against on
    the ranks' shards apart: the frozen prefix (K4, K5) must compute each
    image alike at either batch; cuDNN's layer2-4 need not (printed)."""
    from kgdet_tpu_torch.ops.image import device_normalize
    from kgdet_tpu_torch.tools.dp_step import load_model

    model = load_model(cfg, state, torch.device('cuda'), torch.float32)
    x = device_normalize(torch.as_tensor(batch['image']).cuda(),
                         torch.as_tensor(batch['valid_hw']).cuda())
    per = DP_BATCH // DP_RANKS
    with torch.no_grad():
        whole = model.backbone(x)
        parts = [model.backbone(x[i:i + per])
                 for i in range(0, DP_BATCH, per)]
    diffs = [((w - torch.cat([p[i] for p in parts])).abs().max()
              / w.abs().max()).item() for i, w in enumerate(whole)]
    print(f'backbone f32 at batch {DP_BATCH} against {DP_RANKS} shards of '
          f'{per}, largest difference by output (C2 from K4 and K5, then '
          f'cuDNN\'s layer2-4) relative to its scale: '
          + ', '.join(f'{d:.3e}' for d in diffs), flush=True)
    if diffs[0] != 0:
        fail('the frozen prefix computes an image differently at another '
             'batch')


def shard_sum_grads(torch, cfg, state, batch):
    """The reference of the ranks' summed gradients with their rounding:
    one process takes the forward and backward of each rank's shard alone,
    at the ranks' batch, its loss divided by the global batch's positive
    count (the cascade's count comes from the point targets, not from the
    model), and sums the gradients."""
    from kgdet_tpu_torch.core import loss as loss_mod
    from kgdet_tpu_torch.parallel.dist import shard_batch
    from kgdet_tpu_torch.parallel.train import make_loss_fn
    from kgdet_tpu_torch.tools.dp_step import load_model

    model = load_model(cfg, state, torch.device('cuda'), torch.float32)
    loss_fn = make_loss_fn(model.train(), cfg,
                           tuple(batch['image'].shape[1:3]))
    shards = [shard_batch(batch, r, DP_RANKS) for r in range(DP_RANKS)]
    with torch.no_grad():
        counts = [loss_fn(sh)[1]['num_pos'] for sh in shards]
    count = sum(counts)
    # the loss's one sum over processes, given the global count: each
    # shard's loss must call it once, on that shard's own count, or the
    # reference would divide another term by the count
    calls = []

    def global_count(t):
        calls.append(t.detach().clone())
        return count
    own = loss_mod.global_sum
    loss_mod.global_sum = global_count
    try:
        for sh in shards:
            loss_fn(sh)[0].backward()
    finally:
        loss_mod.global_sum = own
    if len(calls) != len(shards) or not all(
            torch.equal(c, n) for c, n in zip(calls, counts)):
        fail(f'the cascade loss summed {len(calls)} values over processes '
             f'for {len(shards)} shards, not each shard\'s positive count')
    return {n: p.grad.detach().cpu().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def dets_close(what, got, want):
    """Detections by image: the same images, each with as many detections,
    within F32_TOL."""
    import numpy as np
    if sorted(got) != sorted(want):
        fail(f'{what}: images {len(got)} != {len(want)}')
    for img, dets in want.items():
        for a, b in zip(got[img], dets):
            if a.shape != b.shape or not np.allclose(a, b, **F32_TOL):
                fail(f'{what}: the detections of image {img} differ')


def dp_two_ranks(torch, gpu, root, per_step, per_fwd):
    """(a): two ranks over gloo sharing the card against one process on the
    global batch, from the same seeded weights: one step in f32 and one in
    bf16 (kgdet_tpu_torch/tools/dp_step.py), then sharded, gathered
    inference on the validation PNGs. Returns the ranks' launches in
    training and in inference."""
    import numpy as np

    from kgdet_tpu_torch.api import build_model
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.tools import dp_step

    cfg = load_config(CONFIG)
    state = build_model(cfg, device='cpu').init_weights(cfg.seed).state_dict()
    batch = make_train_batches(1, SEED + 20, cfg.head.num_keypts,
                               b=DP_BATCH)[0]
    torch.save(state, os.path.join(root, 'state.pt'))
    np.savez(os.path.join(root, 'batch.npz'), **batch)
    eval_cfg = eval_config(root, 'dp_cfg.py')

    # one process: the reference
    one = {name: dp_step.take_step(cfg, state, batch, 'cuda',
                                   getattr(torch, name))
           for name in ('float32', 'bfloat16')}
    one_infer = dp_step.infer(load_config(eval_cfg), state, 'cuda')
    backbone_batch_rounding(torch, cfg, state, batch)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out = os.path.join(root, 'dp_out')
    run_torchrun(['kgdet_tpu_torch.tools.dp_step', CONFIG, '--state',
                  os.path.join(root, 'state.pt'), '--batch',
                  os.path.join(root, 'batch.npz'), '--out', out, '--dtype',
                  'float32', 'bfloat16', '--infer-config', eval_cfg,
                  '--device', 'cuda:0', '--backend', 'gloo'],
                 os.path.join(root, 'dp_step.log'), nproc=DP_RANKS)
    ranks = [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
             for r in range(DP_RANKS)]
    secs = time.perf_counter() - t0
    if [r['world'] for r in ranks] != [DP_RANKS] * DP_RANKS:
        fail(f'the ranks ran in worlds of {[r["world"] for r in ranks]}')

    train_launches = {k: 0 for k in per_step}
    for name in ('float32', 'bfloat16'):
        steps = [r['steps'][name] for r in ranks]
        for r, st in enumerate(steps):
            if st['launches'] != per_step:
                fail(f'rank {r} {name} step launches {st["launches"]} != '
                     f'{per_step}')
            for k, v in st['launches'].items():
                train_launches[k] += v
        a, b = steps
        for part in ('params', 'momentum'):
            for k in a[part]:
                if not torch.equal(a[part][k], b[part][k]):
                    fail(f'{name}: the ranks\' {part} of {k} differ')
        print(f'data parallel, {name}: {DP_RANKS} ranks x '
              f'{DP_BATCH // DP_RANKS} images, parameters and momentum of '
              f'the {len(a["params"])} tensors bit-equal across the ranks; '
              f'step ms by rank {rates_line(st["ms"] for st in steps)} '
              f'(two ranks sharing one card over gloo: no scaling figure) '
              f'against one process on all {DP_BATCH} '
              f'{one[name]["ms"]:.2f} ms ({gpu})', flush=True)
    got32, want32 = ranks[0]['steps']['float32'], one['float32']
    # the loss terms are the forward's: 1e-4. grad_norm is the norm of the
    # gradients, which differ as grads_close allows (K3's atomics, the
    # ReLUs): it must be the norm of the summed gradients the optimizer
    # took, and differ from one process's by no more than they do
    # (|a| - |b| <= |a - b|)
    def norm(grads, names):
        return torch.stack([grads[n].double().norm()
                            for n in names]).norm().item()
    names = sorted(want32['grads'])
    own = norm(got32['grads'], sorted(got32['grads']))
    apart = torch.stack([(got32['grads'][n].double()
                          - want32['grads'][n].double()).norm()
                         for n in names]).norm().item()
    g2, g1 = got32['logs']['grad_norm'], want32['logs']['grad_norm']
    print(f'data parallel, f32 logs of {DP_RANKS} ranks against one process: '
          + ', '.join(f'{k} {got32["logs"][k]:.6f} / {v:.6f}'
                      for k, v in want32['logs'].items()
                      if k in ('loss', 'loss_cls_3', 'num_pos', 'grad_norm'))
          + f'; the ranks\' summed gradients have norm {own:.6f}, '
          f'{apart:.3e} apart from one process\'s', flush=True)
    for k, v in want32['logs'].items():
        if k != 'grad_norm' and not abs(got32['logs'][k] - v) <= \
                1e-4 * abs(v):
            fail(f'f32 log {k}: {DP_RANKS} ranks {got32["logs"][k]} != one '
                 f'process {v}')
    if not abs(g2 - own) <= 1e-5 * own or \
            not abs(g2 - g1) <= apart + 1e-5 * g1:
        fail(f'f32 grad_norm {g2} of {DP_RANKS} ranks: not the norm {own} '
             f'of their gradients, or further than {apart} from one '
             f'process\'s {g1}')
    grads_close(f'{DP_RANKS} ranks vs one process on all {DP_BATCH}',
                got32['grads'], want32['grads'],
                elementwise_except=BATCH_ROUNDED)
    grads_close(f'{DP_RANKS} ranks vs one process summing their shards',
                got32['grads'], shard_sum_grads(torch, cfg, state, batch))
    groups = GRAD_GROUPS
    ref = {n: g for n, g in want32['grads'].items() if n.startswith(groups)}

    def run(st):
        return st['logs']['loss'], {n: st['grads'][n].float() for n in ref}
    check_bf16_grads(want32['logs']['loss'], ref,
                     run(ranks[0]['steps']['bfloat16']),
                     run(one['bfloat16']), groups,
                     labels=(f'{DP_RANKS} ranks', 'one process'))

    # sharded, gathered inference
    eval_launches = {k: 0 for k in per_fwd}
    batches = 0
    for r, rk in enumerate(ranks):
        inf = rk['infer']
        want = {k: v * inf['batches'] for k, v in per_fwd.items()}
        if inf['launches'] != want:
            fail(f'rank {r} inference launches {inf["launches"]} != {want}')
        for k, v in inf['launches'].items():
            eval_launches[k] += v
        batches += inf['batches']
        dets_close(f'rank {r} gathered detections vs one process',
                   inf['results'], one_infer['results'])
    if batches != one_infer['batches']:
        fail(f'the ranks inferred {batches} batches, one process '
             f'{one_infer["batches"]}')
    print(f'data parallel inference: {DP_IMAGES} PNGs in '
          f'{[rk["infer"]["batches"] for rk in ranks]} batches by rank, '
          f'every image once in the gathered detections on both ranks, '
          f'within {F32_TOL} of one process; launches {eval_launches}; '
          f'the ranks\' part {secs:.1f} s', flush=True)
    return train_launches, eval_launches


def run_torchrun(args, log, nproc=1, timeout=DP_TIMEOUT):
    """``torchrun --standalone --nproc_per_node=<nproc> -m <args>`` in a
    session of its own, killed at ``timeout``; its output, echoed. Fails
    unless it exits 0 (torchrun stops every rank when one fails)."""
    import signal
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           f'--nproc_per_node={nproc}', '-m', *args]
    env = dict(os.environ, PYTHONPATH=ROOT)
    with open(log, 'w') as f:
        p = subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                             start_new_session=True)
        try:
            p.wait(timeout=timeout)
        finally:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    with open(log) as f:
        out = f.read()
    print(out[-3000:], end='', flush=True)
    if p.returncode != 0:
        fail(f'torchrun {" ".join(args[:2])} exited {p.returncode}')
    return out


def dp_nccl_one_rank(torch, gpu, root):
    """(b): tools/train.py --distributed under torchrun, one rank over
    NCCL, one epoch of the training PNGs; then tools/test.py --distributed
    --checkpoint under torchrun against the same CLI in this process."""
    import math

    cfg_path = eval_config(root, 'nccl_cfg.py')
    work = os.path.join(root, 'nccl_work')
    t0 = time.perf_counter()
    out = run_torchrun(['kgdet_tpu_torch.tools.train', cfg_path,
                        '--distributed', '--work-dir', work, '--max-epochs',
                        '1', '--log-interval', '2'],
                       os.path.join(root, 'nccl_train.log'))
    train_s = time.perf_counter() - t0
    steps = DP_IMAGES // DP_BATCH
    if '[dist] process group: nccl, 1 process(es)' not in out:
        fail('tools/train.py --distributed did not run over nccl')
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != steps // 2 or not all(
            math.isfinite(v) for r in recs for v in r.values()
            if not isinstance(v, str)):
        fail(f'the nccl run logged {recs}')
    ckpts = sorted(os.listdir(os.path.join(work, 'checkpoints')))
    if ckpts != [str(steps)]:
        fail(f'the nccl run saved {ckpts}, not step {steps}')
    step_dir = os.path.join(work, 'checkpoints', str(steps))
    t0 = time.perf_counter()
    printed = run_torchrun(['kgdet_tpu_torch.tools.test', cfg_path,
                            '--distributed', '--checkpoint', step_dir,
                            '--json-out', os.path.join(root, 'nccl_test')],
                           os.path.join(root, 'nccl_test.log'))
    test_s = time.perf_counter() - t0
    run_cli([cfg_path, '--checkpoint', step_dir, '--json-out',
             os.path.join(root, 'plain_test')])
    for kind in ('bbox', 'keypoints'):
        copypaste(printed, kind, 12 if kind == 'bbox' else 10)
        with open(os.path.join(root, f'nccl_test.{kind}.json')) as f:
            got = json.load(f)
        with open(os.path.join(root, f'plain_test.{kind}.json')) as f:
            want = json.load(f)
        if got != want:
            fail(f'tools/test.py --distributed {kind} detections differ from '
                 'the same checkpoint without it')
    print(f'data parallel over nccl: tools/train.py --distributed, one rank, '
          f'{steps} steps of {DP_BATCH}, {len(recs)} finite records, '
          f'checkpoint {ckpts[0]}, {train_s:.1f} s; tools/test.py '
          f'--distributed --checkpoint {steps}, its detections bit-equal to '
          f'the run without --distributed, {test_s:.1f} s ({gpu})',
          flush=True)


# tests/test_overfit.py's two fixed images: two garments each
OVERFIT_CANVAS = (64, 96)
OVERFIT_KPTS = 12
OVERFIT_GT = [[(10, 8, 44, 40, 3), (56, 30, 90, 60, 7)],
              [(16, 20, 52, 56, 3), (60, 6, 88, 30, 11)]]


def overfit_batch():
    """tests/test_overfit.py::overfit_batch."""
    import numpy as np
    (H, W), K = OVERFIT_CANVAS, OVERFIT_KPTS
    rng = np.random.RandomState(7)
    B, G = 2, 4
    img = rng.randn(B, H, W, 3).astype(np.float32)
    boxes = np.zeros((B, G, 4), np.float32)
    labels = np.zeros((B, G), np.int32)
    mask = np.zeros((B, G), bool)
    kpts = np.zeros((B, G, K, 3), np.float32)
    for b, lst in enumerate(OVERFIT_GT):
        for g, (x1, y1, x2, y2, c) in enumerate(lst):
            boxes[b, g] = (x1, y1, x2, y2)
            labels[b, g] = c
            mask[b, g] = True
            kpts[b, g, :, 0] = np.linspace(x1 + 2, x2 - 2, K)
            kpts[b, g, :, 1] = np.linspace(y1 + 2, y2 - 2, K)[::-1]
            kpts[b, g, :, 2] = 1
    return {'image': img,
            'valid_hw': np.tile(np.asarray((H, W), np.int32), (B, 1)),
            'gt_bboxes': boxes, 'gt_labels': labels, 'gt_kpts': kpts,
            'gt_mask': mask}


def learning_proof(torch, gpu, per_step):
    """(c): tests/test_torch_train.py::test_overfit_reaches_high_ap_and_kpt
    _accuracy on the card in bf16 through K2, K3, K4 and K5: the tiny R-50
    cascade (64 channels, 12 keypoints) trained with adam at 2e-3 after 10
    warmup steps on the two fixed images, up to 300 steps, stopping at a
    check every 50 steps from step 150 once AP >= 0.99 and the keypoint
    error < 4 px; the test's bounds. Returns the launches of its steps."""
    import numpy as np

    from kgdet_tpu_torch.api import init_trainer, make_predict_fn
    from kgdet_tpu_torch.config import (BackboneConfig, DataConfig,
                                        HeadConfig, KGDetConfig, NeckConfig,
                                        OptimConfig, TestConfig)
    from kgdet_tpu_torch.core.postprocess import detections_to_per_class
    from kgdet_tpu_torch.eval.mean_ap import eval_map

    (H, W), K = OVERFIT_CANVAS, OVERFIT_KPTS
    cfg = KGDetConfig(
        backbone=BackboneConfig(depth=50, frozen_stages=1),
        neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=64,
                        select_out=(2,), gn_groups=32),
        head=HeadConfig(num_classes=13, in_channels=64, feat_channels=64,
                        point_feat_channels=64, stacked_convs=1,
                        num_keypts=K, gn_groups=8),
        test=TestConfig(nms_pre=50, max_per_class=10, max_per_img=20,
                        score_thr=0.0),
        val_data=DataConfig(img_scale=(96, 64), canvas_hw=((H, W),)),
        optim=OptimConfig(type='adam', lr=2e-3, warmup_iters=10,
                          lr_step_epochs=(1000,), total_epochs=1),
        compute_dtype='bfloat16')
    model, _, step = init_trainer(cfg, (H, W), 10 ** 6)
    batch = {k: torch.as_tensor(v).cuda() for k, v in
             overfit_batch().items()}
    predict = make_predict_fn(model, cfg, (H, W))
    feed = {'image': batch['image'],
            'img_hw': torch.tensor([[H, W]] * 2, dtype=torch.float32),
            'scale_factor': torch.ones(2)}
    host = {k: v.cpu().numpy() for k, v in batch.items()}
    gt_b = [host['gt_bboxes'][b][host['gt_mask'][b]] for b in range(2)]
    gt_l = [host['gt_labels'][b][host['gt_mask'][b]] for b in range(2)]

    def evaluate():
        model.eval()
        dets = predict(feed)
        model.train()
        per = detections_to_per_class(dets, num_classes=13)
        m, _ = eval_map([r[0] for r in per], gt_b, gt_l, iou_thr=0.5)
        b0 = dets['det_bboxes'][0].float().cpu().numpy()
        v0 = dets['valid'][0].cpu().numpy()
        kerr = float('inf')
        if v0.any():
            i = int(np.argmax(np.where(v0, b0[:, 4], -1)))
            kp = dets['det_kpts'][0][i].float().cpu().numpy().reshape(K, 3)
            kerr = float(np.linalg.norm(
                kp[:, :2] - host['gt_kpts'][0, 0, :, :2], axis=-1).mean())
        return m, kerr

    ap0, _ = evaluate()
    losses, ap, kerr = [], 0.0, float('inf')
    step_launches = {k: 0 for k in per_step}
    t0 = time.perf_counter()
    for i in range(300):
        before = read_launches()
        losses.append(step(batch)['loss'])
        after = read_launches()
        for k in step_launches:
            step_launches[k] += after[k] - before[k]
        if i >= 149 and (i + 1) % 50 == 0:
            ap, kerr = evaluate()
            if ap >= 0.99 and kerr < 4.0:
                break
    losses = torch.stack(losses).float().cpu().numpy()
    secs = time.perf_counter() - t0
    n = len(losses)
    want = {k: v * n for k, v in per_step.items()}
    print(f'learning proof, bf16 on the card: {n} steps, loss '
          f'{losses[0]:.4f} -> {losses[-1]:.4f}, bbox AP@0.5 {ap0:.3f} -> '
          f'{ap:.3f}, keypoint error {kerr:.2f} px, launches {step_launches} '
          f'over the steps, {secs:.1f} s ({gpu})', flush=True)
    if step_launches != want:
        fail(f'learning proof launches {step_launches} != {want}')
    if not np.isfinite(losses).all() or not losses[-1] < 0.25 * losses[0] \
            or not ap >= 0.5 or not ap > ap0 + 0.3 or not kerr < 4.0:
        fail('the learning proof missed tests/test_overfit.py\'s bounds')
    return step_launches


def phase_data_parallel(torch, gpu, per_step, per_fwd):
    """Phase 11, data parallel on the cascade config: (a) two ranks over
    gloo on the one card against one process, (b) one rank over NCCL
    through the CLIs under torchrun, (c) the learning proof in bf16.
    Returns the launches of (a)'s steps, (a)'s inference and (c)."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix='kgdet_dp_')
    try:
        t0 = time.perf_counter()
        make_eval_set(root, SEED, n_images=DP_IMAGES)
        make_eval_set(root, SEED + 10, n_images=DP_IMAGES, split='train')
        t1 = time.perf_counter()
        dp_train, dp_eval = dp_two_ranks(torch, gpu, root, per_step, per_fwd)
        t2 = time.perf_counter()
        dp_nccl_one_rank(torch, gpu, root)
        t3 = time.perf_counter()
        proof = learning_proof(torch, gpu, per_step)
        t4 = time.perf_counter()
        print(f'phase 11 seconds: PNGs {t1 - t0:.1f}, (a) two ranks '
              f'{t2 - t1:.1f}, (b) nccl {t3 - t2:.1f}, (c) learning proof '
              f'{t4 - t3:.1f} ({gpu})', flush=True)
        return dp_train, dp_eval, proof
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------- phase 12: RetinaNet, SSD300, the DCN backbone
SSD_CONFIG = os.path.join(ROOT, 'configs', 'ssd300_vgg16_deepfashion2.py')
SSD_CANVAS = (300, 300)
# the shipped train_data / val_data batch (32): 2 training steps an epoch
SSD_TRAIN_IMAGES = 64
SSD_VAL_IMAGES = 32
# small square images, resized to 300x300: one aspect group, so that the
# grouped loader makes full batches of 32 of 64 and 32 images
SSD_SIZES = ((300, 300), (240, 240), (360, 360), (420, 420))
# mmdetection v1.x configs/dcn/*_dconv_c3-c5_r50_fpn_1x.py: DCN (v1, one
# group) in stages c3 to c5, 0-based stages 1 to 3
DCN_STAGES = (1, 2, 3)
# the Function over K6+K3 on the step's tensors of these blocks: stride 2
# and stride 1
DCN_FUNCTION_BLOCKS = ('backbone.layer2.0.conv2', 'backbone.layer4.1.conv2')
DCN_GRAD_GROUPS = ('backbone.layer2.', 'backbone.layer3.', 'backbone.layer4.',
                   'neck.', 'bbox_head.kp_rep_block_3.')
BENCH_RUNS = (('cascade', CONFIG, 2, 32), ('ssd300', SSD_CONFIG, 32, 256))


def retina_config():
    """RetinaNet with the recipe of mmdetection v1.x's
    configs/retinanet_r50_fpn_1x.py at the cascade config's width: ResNet-50
    (frozen_stages 1), FPN of 256 channels on C3-C5 with two stride-2 extra
    convs (P3-P7), no norm; 4 stacked convs of 256 a branch, octave base
    scale 4, 3 scales an octave, ratios 0.5 / 1 / 2; MaxIoU 0.5 / 0.4 / 0;
    test nms_pre 1000, IoU 0.5, 100 a image. Built here from the cascade
    config (no config file holds it)."""
    from kgdet_tpu_torch.config import (AssignConfig, HeadConfig,
                                        NeckConfig, TestConfig, load_config)
    cfg = load_config(CONFIG)
    return 'RetinaNet R-50 FPN (retinanet_r50_fpn_1x recipe)', cfg.replace(
        neck=NeckConfig(in_channels=(256, 512, 1024, 2048), out_channels=256,
                        start_level=1, num_outs=5, add_extra_convs=True,
                        select_out=None, norm=None),
        head=HeadConfig(type='RetinaHead', num_classes=13, in_channels=256,
                        feat_channels=256, stacked_convs=4, norm=None,
                        octave_base_scale=4, scales_per_octave=3,
                        anchor_ratios=(0.5, 1.0, 2.0),
                        point_strides=(8, 16, 32, 64, 128)),
        assigner=AssignConfig(type='MaxIoUAssigner', pos_iou_thr=0.5,
                              neg_iou_thr=0.4, min_pos_iou=0.0),
        refine_assigner=None,
        test=TestConfig(nms_pre=1000, nms_iou_thr=0.5, max_per_img=100))


def dcn_config():
    """The cascade config with backbone.dcn_stages=DCN_STAGES."""
    from kgdet_tpu_torch.config import load_config
    cfg = load_config(CONFIG)
    return 'the cascade with DCN c3-c5', cfg.replace(
        backbone=dataclasses.replace(cfg.backbone, dcn_stages=DCN_STAGES))


def phase_retina(torch, gpu):
    """(a) RetinaNet at full width: 2 requests of 2 served (K4 1, K5 3 a
    forward, nothing else), the head outputs against the model on its
    plain kernels (phase 2's bounds), 2 train steps through init_trainer.
    Returns the launches served and trained."""
    prefix = launch_counts(stem_pool=1, frozen_bottleneck=3)
    config = retina_config()
    model, cfg, req, served = phase_serving(
        torch, gpu, config,
        {**prefix, 'greedy_nms': 1, 'bn_epilogue': R50_EPILOGUES})
    phase_profile(torch, model, cfg, req, gpu)
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batches, trained = take_train_steps(
        torch, gpu, config, prefix, n_logs=5,
        free_name='bbox_head.retina_cls.weight')
    phase_train_profile(torch, model, cfg, optimizer, batches[0], gpu)
    del model, optimizer
    torch.cuda.empty_cache()
    return served, trained


def ssd_requests(n, seed, b):
    """Seeded serving batches at 300x300: uint8 images, extents of the
    resized images (every other one letterboxed to 300x225)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    hw = np.tile(np.array([[300, 300], [225, 300]], np.float32), (b // 2, 1))
    return [{'image': rng.randint(0, 256, (b, *SSD_CANVAS, 3))
             .astype(np.uint8), 'img_hw': hw,
             'scale_factor': np.full((b,), 0.5, np.float32)}
            for _ in range(n)]


def ssd_train_batches(n, seed, b, num_keypts):
    """Seeded training batches at 300x300: 8 boxes an image of 30 to 200
    pixels a side."""
    import numpy as np
    rng = np.random.RandomState(seed)
    G = 8
    out = []
    for _ in range(n):
        boxes = np.zeros((b, G, 4), np.float32)
        boxes[..., :2] = rng.uniform(0, 150, (b, G, 2))
        boxes[..., 2:] = boxes[..., :2] + rng.uniform(30, 150, (b, G, 2))
        kpts = rng.uniform(0, 300, (b, G, num_keypts, 3)).astype(np.float32)
        kpts[..., 2] = 1
        out.append({
            'image': rng.randint(0, 256, (b, *SSD_CANVAS, 3)).astype(
                np.uint8),
            'valid_hw': np.tile(np.array([[300, 300]], np.int32), (b, 1)),
            'gt_bboxes': boxes,
            'gt_labels': rng.randint(1, 14, (b, G)).astype(np.int32),
            'gt_kpts': kpts, 'gt_mask': np.ones((b, G), bool)})
    return out


def ssd_cli_config(root):
    """The shipped SSD300 config with its data under ``root`` and
    test.score_thr 0.0, as a config file that runs the shipped one."""
    path = os.path.join(root, 'ssd_cfg.py')
    with open(path, 'w') as f:
        f.write(
            'import dataclasses\nimport runpy\n'
            f'config = runpy.run_path({SSD_CONFIG!r})["config"]\n'
            'config = config.replace(\n'
            '    train_data=dataclasses.replace(\n'
            '        config.train_data,\n'
            f'        ann_file={root!r} + "/train-coco_style.json",\n'
            f'        img_prefix={root!r} + "/train/image"),\n'
            '    val_data=dataclasses.replace(\n'
            '        config.val_data,\n'
            f'        ann_file={root!r} + "/validation-coco_style.json",\n'
            f'        img_prefix={root!r} + "/validation/image"),\n'
            '    test=dataclasses.replace(config.test, score_thr=0.0))\n')
    return path


def phase_ssd(torch, gpu):
    """(b) configs/ssd300_vgg16_deepfashion2.py as shipped (batch 32,
    300x300; no TPU kernel on this path in either package): 2 batches of
    32 served (K9 once a batch, no other kernel) and 2 train steps at batch
    32 with every kernel counter at 0;
    then tools/train.py --validate for one epoch of 2 steps on synthetic
    PNGs with the config's photometric distortion, expand and min-IoU crop.
    Returns the launches served and trained."""
    import math
    import shutil
    import tempfile

    from kgdet_tpu_torch.api import build_model, init_trainer, load_config, \
        make_predict_fn
    from kgdet_tpu_torch.parallel.train import frozen_param_mask

    cfg = load_config(SSD_CONFIG)
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, score_thr=0.0))
    b = cfg.val_data.batch_size
    zero = launch_counts()
    nms_only = launch_counts(greedy_nms=SERVED)
    model = build_model(cfg).init_weights(SEED).eval()
    predict = make_predict_fn(model, cfg, SSD_CANVAS)
    reqs = ssd_requests(SERVED, SEED, b)
    predict(reqs[0])
    reset_launches()
    dets, secs = serve(torch, predict, reqs)
    served = read_launches()
    if served != nms_only:
        fail(f'SSD300 served with kernel launches {served} != {nms_only}')
    n_valid = 0
    for d in dets:
        if not all(torch.isfinite(v).all() for v in d.values()
                   if v.is_floating_point()) or \
                tuple(d['det_bboxes'].shape) != (b, cfg.test.max_per_img, 5) \
                or tuple(d['det_kpts'].shape) != (b, cfg.test.max_per_img, 3):
            fail(f'SSD300 detections {[tuple(v.shape) for v in d.values()]}')
        n_valid += int(d['valid'].sum())
    if n_valid == 0:
        fail('SSD300: no detection survived NMS at score_thr 0')
    print(f'SSD300 serving: {SERVED} batches x {b} images at 300x300, '
          f'{cfg.compute_dtype}, {n_valid} valid detections, K9 alone '
          f'launched; {b * SERVED / secs:.2f} img/s ({gpu})', flush=True)
    phase_profile(torch, model, cfg, reqs[0], gpu)
    del model, predict
    torch.cuda.empty_cache()

    model, optimizer, step = init_trainer(cfg, SSD_CANVAS,
                                          steps_per_epoch=1000)
    frozen = frozen_param_mask(model, cfg.backbone.frozen_stages)
    free_name = 'bbox_head.cls_convs.0.weight'
    params = dict(model.named_parameters())
    if any(frozen.values()) or frozen[free_name]:
        fail('SSD300 (frozen_stages -1) froze parameters')
    start = params[free_name].detach().clone()
    batches = ssd_train_batches(1 + TRAIN_STEPS, SEED + 1, b,
                                cfg.head.num_keypts)
    step(batches[0])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = [step(x) for x in batches[1:]]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    trained = read_launches()
    if trained != zero:
        fail(f'SSD300 trained with kernel launches {trained}')
    for lg in logs:
        vals = {k: v.item() for k, v in lg.items()}
        if len(vals) != 5 or not all(math.isfinite(v)
                                     for v in vals.values()):
            fail(f'SSD300 train step logs {vals}')
    if torch.equal(params[free_name].detach(), start):
        fail(f'SSD300: {free_name} did not move')
    print(f'SSD300 training: {TRAIN_STEPS} steps x {b} images, loss '
          f'{logs[-1]["loss"].item():.4f}, num_pos '
          f'{logs[-1]["num_pos"].item():.0f}, no kernel launched; '
          f'{secs / TRAIN_STEPS * 1e3:.2f} ms a step ({gpu})', flush=True)
    phase_train_profile(torch, model, cfg, optimizer, batches[0], gpu,
                        canvas=SSD_CANVAS)
    del model, optimizer, step
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix='kgdet_ssd_')
    try:
        t0 = time.perf_counter()
        make_eval_set(root, SEED + 20, n_images=SSD_TRAIN_IMAGES,
                      split='train', sizes=SSD_SIZES)
        make_eval_set(root, SEED + 21, n_images=SSD_VAL_IMAGES,
                      sizes=SSD_SIZES)
        cfg_path = ssd_cli_config(root)
        data = load_config(cfg_path).train_data
        if not (data.photo_metric_distortion and data.expand
                and data.random_crop):
            fail('the SSD300 config no longer turns its augmentations on')
        work = os.path.join(root, 'work')
        runner, printed = run_train_cli([cfg_path, '--work-dir', work,
                                         '--max-epochs', '1', '--validate',
                                         '--log-interval', '1'])
        steps = SSD_TRAIN_IMAGES // data.batch_size
        with open(os.path.join(work, 'train_log.jsonl')) as f:
            recs = [json.loads(line) for line in f]
        train_recs = [r for r in recs if r['mode'] == 'train']
        if runner.step != steps or len(train_recs) != steps or not all(
                math.isfinite(v) for r in recs for v in r.values()
                if not isinstance(v, str)):
            fail(f'SSD300 tools/train.py: step {runner.step}, records {recs}')
        ckpts = sorted(os.listdir(os.path.join(work, 'checkpoints')))
        if ckpts != [str(steps)]:
            fail(f'SSD300 tools/train.py saved {ckpts}, not step {steps}')
        lines = [ln for ln in printed.splitlines()
                 if 'bbox_mAP_copypaste: ' in ln]
        if len(lines) != 1:
            fail(f'SSD300 tools/train.py --validate printed {lines}')
        print(f'SSD300 tools/train.py --validate: {SSD_TRAIN_IMAGES} '
              f'training and {SSD_VAL_IMAGES} validation PNGs, photometric '
              f'distortion, expand and min-IoU crop on, {steps} steps, '
              f'{len(recs)} finite records, checkpoint {ckpts[0]}, '
              f'{time.perf_counter() - t0:.1f} s ({gpu})', flush=True)
        del runner
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return served, trained


def calibrate_offsets(torch, model, req, cells=0.25, forward=None):
    """Seeded offset convs in place of their zero init, so that the DCN
    blocks sample off the pixel grid: each block's conv2_offset gets
    N(0, sd) weights, sd set from the block's input so that its offsets
    have a standard deviation of about ``cells`` grid cells. ``forward``,
    where given, runs the model instead of a detector forward on ``req``."""
    from kgdet_tpu_torch.models.resnet import Bottleneck
    from kgdet_tpu_torch.ops.image import device_normalize

    blocks = [m for m in model.modules()
              if isinstance(m, Bottleneck) and m.use_dcn]
    rms = {}
    hooks = [blk.bn1.register_forward_hook(
        lambda mod, args, out, blk=blk: rms.__setitem__(
            blk, torch.relu(out.float()).square().mean().sqrt().item()))
        for blk in blocks]
    with torch.inference_mode():
        if forward is not None:
            forward()
        else:
            model(device_normalize(torch.as_tensor(req['image']).cuda(),
                                   torch.as_tensor(req['img_hw']).cuda()))
    for h in hooks:
        h.remove()
    gen = torch.Generator().manual_seed(SEED + 5)
    with torch.no_grad():
        for blk in blocks:
            w = blk.conv2_offset.weight
            sd = cells / (w[0].numel() ** 0.5 * max(rms[blk], 1e-6))
            w.copy_(torch.randn(w.shape, generator=gen) * sd)
    print(f'DCN: {len(blocks)} offset convs given N(0, sd) weights for '
          f'offsets of about {cells} cell', flush=True)


def dcn_levels(torch, model, image):
    """C3 to C5 and the last-stage head outputs of one forward."""
    with torch.inference_mode():
        feats = model.backbone(image.to(model.dtype))
        outs = model.bbox_head(model.neck(feats))
    return {**{f'C{i + 2}': f for i, f in enumerate(feats) if i > 0},
            **last_stage(outs)}


def hold_dcn_against_plain(torch, model, req):
    """The DCN cascade's C3-C5 and last-stage head outputs on its kernels
    against on their plain versions: f32 within F32_TOL with its atol
    scaled by the map's largest value (check_pair's ``scaled`` form: C4
    and C5 reach about 100, and the DCN blocks carry each other's f32
    rounding into their sampling positions), the frozen prefix on K4+K5 on
    both sides (with it plain too, printed beside); bf16 error against the
    f32 plain model within BF16_RATIO x the plain bf16 model's."""
    from kgdet_tpu_torch.ops import plain_kernels
    from kgdet_tpu_torch.ops.image import device_normalize

    image = device_normalize(torch.as_tensor(req['image']).cuda(),
                             torch.as_tensor(req['img_hw']).cuda())
    dtype0 = model.dtype
    runs = {}
    try:
        for dtype in (torch.bfloat16, torch.float32):
            model.dtype = dtype
            for plain in (False, True):
                with plain_kernels(plain):
                    runs[dtype, plain] = dcn_levels(torch, model, image)
            with plain_kernels(), prefix_on_its_kernels(model):
                runs[dtype, 'head'] = dcn_levels(torch, model, image)
    finally:
        model.dtype = dtype0
    f32 = torch.float32
    ref = runs[f32, True]
    for k in ref:
        got, same = runs[f32, False][k].float(), runs[f32, 'head'][k].float()
        e32, e_all = max_err(got, same), max_err(got, ref[k])
        ek = max_err(runs[torch.bfloat16, False][k], ref[k])
        ep = max_err(runs[torch.bfloat16, True][k], ref[k])
        atol = F32_TOL['atol'] * max(1.0, same.abs().max().item())
        print(f'DCN {k}: f32 kernels vs plain on the same prefix {e32:.3e} '
              f'(rtol {F32_TOL["rtol"]}, atol {atol:.3e}), with the prefix '
              f'plain too {e_all:.3e}; bf16 vs f32 plain: kernels {ek:.3e}, '
              f'plain {ep:.3e} (bound {BF16_RATIO} x plain)', flush=True)
        if not torch.allclose(got, same, rtol=F32_TOL['rtol'], atol=atol):
            fail(f'DCN {k}: the f32 kernel model differs from the plain one '
                 f'by {e32:.3e}')
        if not ek <= BF16_RATIO * ep:
            fail(f'DCN {k}: bf16 kernel model err {ek:.3e} > {BF16_RATIO} x '
                 f'plain {ep:.3e}')


def dcn_function(torch, model, loss_fn, batch, blocks=DCN_FUNCTION_BLOCKS):
    """ops/deform.py::deform_conv (the Function over K6 and K3, then the
    contraction) against the same over their plain versions, f32, on the
    tensors that the train step's forward hands the DeformConv3x3 modules
    ``blocks`` in their first call (map, offsets, tap-major weight; a
    head's module runs once a level, the first on the largest) and a
    seeded cotangent: the output and every gradient within MODEL_F32_REL
    of its scale (no ReLU between)."""
    from kgdet_tpu_torch.ops import plain_kernels
    from kgdet_tpu_torch.ops.deform import deform_conv

    modules = dict(model.named_modules())
    caught = {}
    # a forward hook that returns a value replaces the module's output:
    # these return None
    hooks = [modules[n].register_forward_hook(
        lambda mod, args, out, n=n: None if n in caught else
        caught.__setitem__(n, [a.detach() for a in args])) for n in blocks]
    model.dtype = torch.float32
    try:
        with torch.no_grad():
            loss_fn(batch)
    finally:
        for h in hooks:
            h.remove()
    gen = torch.Generator(device='cuda').manual_seed(SEED + 6)
    names = ('output', 'grad map', 'grad offsets', 'grad weight')
    for n in blocks:
        conv = modules[n]
        x, offsets = caught[n]
        Bn, _, Ho, Wo = offsets.shape
        rel = offsets.permute(0, 2, 3, 1).reshape(Bn, Ho, Wo, 9, 2) \
            + conv.tap_grid
        feat = x.permute(0, 2, 3, 1).contiguous()
        w = conv.tap_major(torch.float32).detach()
        ct = torch.randn((Bn, Ho, Wo, w.shape[-1]), device='cuda',
                         generator=gen)

        def run(plain):
            leaves = [t.clone().requires_grad_() for t in (feat, rel, w)]
            with plain_kernels(plain):
                out = deform_conv(*leaves, stride=conv.stride)
            return [out, *torch.autograd.grad(out, leaves, ct)]
        got, want = run(False), run(True)
        errs = [max_err(g, v) / v.abs().max().item()
                for g, v in zip(got, want)]
        worst = max(zip(errs, names))
        print(f'Function over K6+K3 vs plain on the train step\'s tensors, '
              f'f32, {n} (map {feat.shape[1]}x{feat.shape[2]}x'
              f'{feat.shape[3]}, stride {conv.stride}, offsets rms '
              f'{offsets.float().square().mean().sqrt().item():.3e}): worst '
              f'{worst[0]:.3e} of its scale ({worst[1]}; bound '
              f'{MODEL_F32_REL}; grad map by f32 atomics)', flush=True)
        if not all(e <= MODEL_F32_REL for e in errs):
            fail(f'f32: the Function over K6 and K3 differs from the plain '
                 f'one at {n}: ' + ', '.join(f'{lb} {e:.3e}'
                                             for e, lb in zip(errs, names)))


def phase_dcn(torch, gpu):
    """(c) The cascade on the DCN backbone: served (K1 12, K4 1, K5 3, K6
    13 a forward) with offset convs moved off zero, C3-C5 and the head
    outputs against the plain kernels; 2 train steps (K2 2, K3 15, K4 1,
    K5 3, K6 13 a step); the Function over K6+K3 on a step's tensors; the
    model gradients on its kernels against their plain versions with the
    prefix the same on both sides, by the whole-model rule, and in bf16.
    Returns the launches served and trained."""
    from kgdet_tpu_torch.parallel.train import make_loss_fn

    prefix = dict(stem_pool=1, frozen_bottleneck=3)
    n_dcn = sum((4, 6, 3)[s - 1] for s in DCN_STAGES)
    config = dcn_config()
    model, cfg, req, served = phase_serving(
        torch, gpu, config, launch_counts(
            deform_fused=12, deform_sample_cols=n_dcn, greedy_nms=1,
            bn_epilogue=R50_EPILOGUES - n_dcn, **prefix),
        compare=False,
        prepare=lambda m, r: calibrate_offsets(torch, m, r))
    hold_dcn_against_plain(torch, model, req)
    phase_profile(torch, model, cfg, req, gpu)
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batches, trained = take_train_steps(
        torch, gpu, config, launch_counts(
            deform_sample_split=2, deform_sample_bwd=2 + n_dcn,
            deform_sample_cols=n_dcn, **prefix),
        n_logs=12, free_name='backbone.layer2.0.conv2_offset.weight')
    loss_fn = make_loss_fn(model, cfg, CANVAS)
    dcn_function(torch, model, loss_fn, batches[0])

    def run(dtype, plain):
        return loss_and_grads(model, optimizer, loss_fn, DCN_GRAD_GROUPS,
                              dtype, plain, batches[0], same_prefix=True)
    ref_loss, ref = head32 = run(torch.float32, True)
    check_same_prefix_grads('K6+K3 in the DCN stages, K2+K3 in the head',
                            run(torch.float32, False), head32)
    check_bf16_grads(ref_loss, ref, run(torch.bfloat16, False),
                     run(torch.bfloat16, True), DCN_GRAD_GROUPS)
    optimizer.zero_grad()
    model.dtype = torch.bfloat16
    phase_train_profile(torch, model, cfg, optimizer, batches[0], gpu)
    del model, optimizer
    torch.cuda.empty_cache()
    return served, trained


def phase_benchmark(torch, gpu):
    """(d) tools/benchmark.py --synthetic as its own process on the cascade
    config (batch 2, 32 images) and on SSD300 (batch 32, 256 images): exit
    0 and its 'Overall fps' line, echoed."""
    for name, config, b, n in BENCH_RUNS:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, '-m', 'kgdet_tpu_torch.tools.benchmark', config,
             '--synthetic', '--batch-size', str(b), '--num-images', str(n)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith('Overall fps: ')]
        if res.returncode != 0 or len(lines) != 1:
            fail(f'tools/benchmark.py on {name} exited {res.returncode}: '
                 f'{res.stdout[-800:]} {res.stderr[-1500:]}')
        print(f'tools/benchmark.py --synthetic {name}: {lines[0]} '
              f'(process {time.perf_counter() - t0:.1f} s; {gpu})',
              flush=True)


def phase_anchor_and_dcn(torch, gpu):
    """Phase 12: (a) RetinaNet, (b) SSD300, (c) the DCN cascade, (d)
    tools/benchmark.py. Returns the launches of each path."""
    t = [time.perf_counter()]
    launches = {}
    launches['retina_serving'], launches['retina_training'] = \
        phase_retina(torch, gpu)
    t.append(time.perf_counter())
    launches['ssd_serving'], launches['ssd_training'] = phase_ssd(torch, gpu)
    t.append(time.perf_counter())
    launches['dcn_serving'], launches['dcn_training'] = phase_dcn(torch, gpu)
    t.append(time.perf_counter())
    phase_benchmark(torch, gpu)
    t.append(time.perf_counter())
    print('phase 12 seconds: ' + ', '.join(
        f'{k} {b - a:.1f}' for k, a, b in zip(
            ('(a) retina', '(b) ssd300', '(c) dcn', '(d) benchmark'), t,
            t[1:])) + f' ({gpu})', flush=True)
    return launches


# ------------------- phase 13: GA-Retina, FCOS, the backbone and neck extras
# mmdetection v1.x configs/guided_anchoring/ga_retinanet_r50_caffe_fpn_1x.py
# and configs/fcos/fcos_r50_caffe_fpn_gn_1x_4gpu.py share the caffe-style
# ResNet-50 (frozen_stages 1) and the FPN on C3-C5 with extra convs (P3-P7)
FPN_P3_P7 = dict(in_channels=(256, 512, 1024, 2048), out_channels=256,
                 start_level=1, num_outs=5, add_extra_convs=True,
                 select_out=None, norm=None)
# the Function over K6+K3 on the step's tensors of GA's feature adaption
GA_FUNCTION_BLOCKS = ('bbox_head.feature_adaption_cls.conv_adaption',)
GA_GRAD_GROUPS = ('backbone.layer2.', 'backbone.layer3.', 'backbone.layer4.',
                  'neck.', 'bbox_head.')
# the four two-stage configs whose backbones and necks the port builds
TWO_STAGE_CONFIGS = tuple(
    os.path.join(ROOT, 'configs', f'{name}_1x_deepfashion2.py') for name in (
        'faster_rcnn_r50_caffe_c4', 'faster_rcnn_x101_32x4d_fpn',
        'faster_rcnn_hrnetv2p_w32', 'libra_faster_rcnn_r50_fpn'))


def caffe_recipe(name, head, assigner):
    """The cascade config cut to a single-stage recipe of mmdetection v1.x:
    caffe-style ResNet-50, FPN_P3_P7, ``head``; test nms_pre 1000, IoU 0.5,
    100 a image."""
    from kgdet_tpu_torch.config import NeckConfig, TestConfig, load_config
    cfg = load_config(CONFIG)
    return name, cfg.replace(
        backbone=dataclasses.replace(cfg.backbone, style='caffe'),
        neck=NeckConfig(**FPN_P3_P7), head=head, assigner=assigner,
        refine_assigner=None,
        test=TestConfig(nms_pre=1000, nms_iou_thr=0.5, max_per_img=100))


def ga_config():
    """GA-Retina (ga_retinanet_r50_caffe_fpn_1x) as far as the JAX
    HeadConfig expresses it: 4 stacked convs of 256 a branch, no norm,
    octave base scale 4, 3 scales an octave, ratios 0.5 / 1 / 2 for the
    approx anchors; one assigner for the approx and the guided anchors
    (MaxIoU 0.5 / 0.4 / 0: the JAX loss takes one)."""
    from kgdet_tpu_torch.config import AssignConfig, HeadConfig
    return caffe_recipe(
        'GA-Retina R-50 caffe FPN (ga_retinanet_r50_caffe_fpn_1x recipe)',
        HeadConfig(type='GARetinaHead', num_classes=13, in_channels=256,
                   feat_channels=256, stacked_convs=4, norm=None,
                   octave_base_scale=4, scales_per_octave=3,
                   anchor_ratios=(0.5, 1.0, 2.0),
                   point_strides=(8, 16, 32, 64, 128)),
        AssignConfig(type='MaxIoUAssigner', pos_iou_thr=0.5,
                     neg_iou_thr=0.4, min_pos_iou=0.0))


def fcos_config():
    """FCOS (fcos_r50_caffe_fpn_gn_1x_4gpu): 4 stacked GN convs of 256 a
    branch, strides 8 to 128 (the JAX FPN has neither
    extra_convs_on_inputs=False nor relu_before_extra_convs: its P6 reads
    C5)."""
    from kgdet_tpu_torch.config import AssignConfig, HeadConfig
    return caffe_recipe(
        'FCOS R-50 caffe FPN GN (fcos_r50_caffe_fpn_gn_1x recipe)',
        HeadConfig(type='FCOSHead', num_classes=13, in_channels=256,
                   feat_channels=256, stacked_convs=4, norm='gn',
                   gn_groups=32, point_strides=(8, 16, 32, 64, 128)),
        AssignConfig(type='PointAssigner'))


def phase_ga(torch, gpu):
    """(a) GA-Retina at full width: 2 requests of 2 served (K4 1, K5 3, K6
    10 a forward: two feature adaptions a level), the head outputs against
    the plain kernels; 2 train steps (K3 10, K4 1, K5 3, K6 10 a step); the
    Function over K6+K3 on the step's P3 tensors of feature_adaption_cls;
    the model's gradients against the plain kernels' with the prefix the
    same on both sides (the whole-model rule) and in bf16. Returns the
    launches served and trained."""
    from kgdet_tpu_torch.parallel.train import make_loss_fn

    prefix = dict(stem_pool=1, frozen_bottleneck=3)
    config = ga_config()
    n_fa = 2 * len(config[1].head.point_strides)
    model, cfg, req, served = phase_serving(
        torch, gpu, config, launch_counts(deform_sample_cols=n_fa,
                                          greedy_nms=1,
                                          bn_epilogue=R50_EPILOGUES,
                                          **prefix))
    phase_profile(torch, model, cfg, req, gpu)
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batches, trained = take_train_steps(
        torch, gpu, config, launch_counts(
            deform_sample_cols=n_fa, deform_sample_bwd=n_fa, **prefix),
        n_logs=7, free_name='bbox_head.retina_cls.weight')
    loss_fn = make_loss_fn(model, cfg, CANVAS)
    dcn_function(torch, model, loss_fn, batches[0], GA_FUNCTION_BLOCKS)

    def run(dtype, plain):
        return loss_and_grads(model, optimizer, loss_fn, GA_GRAD_GROUPS,
                              dtype, plain, batches[0], same_prefix=True)
    ref_loss, ref = head32 = run(torch.float32, True)
    check_same_prefix_grads('K6+K3 in the feature adaption',
                            run(torch.float32, False), head32)
    check_bf16_grads(ref_loss, ref, run(torch.bfloat16, False),
                     run(torch.bfloat16, True), GA_GRAD_GROUPS)
    optimizer.zero_grad()
    model.dtype = torch.bfloat16
    phase_train_profile(torch, model, cfg, optimizer, batches[0], gpu)
    del model, optimizer
    torch.cuda.empty_cache()
    return served, trained


def phase_fcos(torch, gpu):
    """(b) FCOS at full width: 2 requests of 2 served (K4 1, K5 3 a
    forward, nothing else), the head outputs against the plain prefix; 2
    train steps (K4 1, K5 3 a step). Returns the launches served and
    trained."""
    prefix = launch_counts(stem_pool=1, frozen_bottleneck=3)
    config = fcos_config()
    model, cfg, req, served = phase_serving(
        torch, gpu, config,
        {**prefix, 'greedy_nms': 1, 'bn_epilogue': R50_EPILOGUES})
    phase_profile(torch, model, cfg, req, gpu)
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batches, trained = take_train_steps(
        torch, gpu, config, prefix, n_logs=6,
        free_name='bbox_head.fcos_cls.weight')
    phase_train_profile(torch, model, cfg, optimizer, batches[0], gpu)
    del model, optimizer
    torch.cuda.empty_cache()
    return served, trained


def build_trunk(torch, cfg):
    """A backbone and its neck (None: the identity neck) under the
    detector's attribute names, built as the config says, seeded weights,
    on the card."""
    from kgdet_tpu_torch.models.detector import build_backbone, build_neck

    class Trunk(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = build_backbone(cfg.backbone)
            self.neck = build_neck(cfg.neck)

        def forward(self, x):
            feats = self.backbone(x)
            return feats if self.neck is None else self.neck(feats)
    trunk = Trunk()
    gen = torch.Generator().manual_seed(SEED)
    for part in (trunk.backbone, trunk.neck):
        if part is not None:
            part.init_weights(gen)
    return trunk.cuda()


def trunk_step(torch, gpu, trunk, cfg, name, per_step):
    """One forward and backward of ``trunk`` at batch B on the canvas in
    bf16 and one SGD update: ``per_step`` launches, finite outputs and
    gradients, frozen parameters bit-equal, a free one moved; prints the
    ms and the peak memory. Returns the launches."""
    from kgdet_tpu_torch.parallel.train import SGDOptimizer, \
        frozen_param_mask

    x = torch.randn((B, *CANVAS, 3), generator=torch.Generator(
        device='cuda').manual_seed(SEED), device='cuda').to(torch.bfloat16)
    opt = SGDOptimizer(trunk, cfg, steps_per_epoch=1000)
    frozen = frozen_param_mask(trunk, cfg.backbone.frozen_stages)
    params = dict(trunk.named_parameters())
    kept = {n: p.detach().clone() for n, p in params.items() if frozen[n]}
    free = next(n for n in params if not frozen[n])
    before = params[free].detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    outs = trunk(x)
    loss = sum(o.float().square().mean() for o in outs)
    loss.backward()
    opt.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = read_launches()
    if got != per_step:
        fail(f'{name}: launch counts {got} != {per_step} for one step')
    if not all(torch.isfinite(o).all() for o in outs) or not all(
            torch.isfinite(p.grad).all() for p in params.values()
            if p.grad is not None):
        fail(f'{name}: non-finite outputs or gradients')
    if any(not torch.equal(params[n], v) for n, v in kept.items()):
        fail(f'{name}: a frozen parameter changed')
    if torch.equal(params[free], before):
        fail(f'{name}: {free} did not move')
    print(f'{name}: outputs ' + ', '.join(
        'x'.join(map(str, o.shape[1:])) for o in outs) + f'; one bf16 step '
        f'at batch {B} {CANVAS[0]}x{CANVAS[1]} (forward, backward, SGD) '
        f'{ms:.1f} ms with its first calls, launches {got}, {len(kept)} '
        f'frozen parameters bit-equal, peak memory '
        f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({gpu})',
        flush=True)
    return got


def hold_trunk_against_plain(torch, trunk, x):
    """The DCN trunk's C3 to C5 on its kernels against on their plain
    versions: f32 within F32_TOL with atol scaled by the map's largest
    value (as phase 12 (c)), bf16 error against the f32 plain run within
    BF16_RATIO x the plain bf16 run's."""
    from kgdet_tpu_torch.ops import plain_kernels
    runs = {}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for plain in (False, True):
                with plain_kernels(plain), prefix_on_its_kernels(trunk):
                    runs[dtype, plain] = trunk.backbone(x.to(dtype))
    ref = runs[torch.float32, True]
    for i, r in enumerate(ref):
        if i == 0:
            continue
        got = runs[torch.float32, False][i]
        e32 = max_err(got, r)
        ek = max_err(runs[torch.bfloat16, False][i], r)
        ep = max_err(runs[torch.bfloat16, True][i], r)
        atol = F32_TOL['atol'] * max(1.0, r.abs().max().item())
        print(f'ResNeXt-101 32x4d DCN C{i + 2}: f32 kernels vs plain '
              f'{e32:.3e} (rtol {F32_TOL["rtol"]}, atol {atol:.3e}); bf16 vs '
              f'f32 plain: kernels {ek:.3e}, plain {ep:.3e} (bound '
              f'{BF16_RATIO} x plain)', flush=True)
        if not torch.allclose(got, r, rtol=F32_TOL['rtol'], atol=atol):
            fail(f'ResNeXt DCN C{i + 2}: the f32 kernels differ from the '
                 f'plain versions by {e32:.3e}')
        if not ek <= BF16_RATIO * ep:
            fail(f'ResNeXt DCN C{i + 2}: bf16 kernel err {ek:.3e} > '
                 f'{BF16_RATIO} x plain {ep:.3e}')


def phase_extras(torch, gpu):
    """(d) The backbones and necks of the four two-stage configs, built by
    build_backbone / build_neck from the files as they ship (their trunks
    alone: phases 14 and 15 step the whole detectors), each one bf16 step
    at batch B on the
    canvas (K4 1 / K5 3 where the frozen prefix applies: the caffe C4
    ResNet-50 and Libra's ResNet-50; none for ResNeXt and HRNet); then
    ResNeXt-101 32x4d with grouped DCN in c3-c5 (K6 30 a forward, K3 30 a
    step), its offset convs seeded off zero, C3-C5 against the plain
    kernels. Returns the launches of the four steps summed and of the DCN
    trunk's step."""
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.models.resnet import DeformConv3x3

    total = launch_counts()
    for path in TWO_STAGE_CONFIGS:
        cfg = load_config(path)
        trunk = build_trunk(torch, cfg)
        prefix = getattr(trunk.backbone, 'use_prefix', False)
        per = launch_counts(stem_pool=1, frozen_bottleneck=3) if prefix \
            else launch_counts()
        got = trunk_step(torch, gpu, trunk, cfg,
                         os.path.relpath(path, ROOT), per)
        total = {k: total[k] + got[k] for k in total}
        del trunk
        torch.cuda.empty_cache()

    cfg = load_config(TWO_STAGE_CONFIGS[1])
    cfg = cfg.replace(backbone=dataclasses.replace(cfg.backbone,
                                                   dcn_stages=DCN_STAGES))
    trunk = build_trunk(torch, cfg)
    n_dcn = sum(isinstance(m, DeformConv3x3) for m in trunk.modules())
    if n_dcn != 30 or trunk.backbone.layer3[0].conv2.groups != 32:
        fail(f'ResNeXt-101 32x4d DCN c3-c5: {n_dcn} grouped DCN blocks')
    x = torch.randn((B, *CANVAS, 3), generator=torch.Generator(
        device='cuda').manual_seed(SEED + 7), device='cuda')
    calibrate_offsets(torch, trunk, None,
                      forward=lambda: trunk.backbone(x.to(torch.bfloat16)))
    hold_trunk_against_plain(torch, trunk, x)
    got = trunk_step(torch, gpu, trunk, cfg,
                     'ResNeXt-101 32x4d, grouped DCN c3-c5 (x101 config)',
                     launch_counts(deform_sample_cols=n_dcn,
                                   deform_sample_bwd=n_dcn))
    del trunk
    torch.cuda.empty_cache()
    return total, got


def phase_ga_fcos_and_extras(torch, gpu):
    """Phase 13: (a) GA-Retina, (b) FCOS, (d) the backbones and necks of
    the two-stage configs and the ResNeXt DCN trunk ((c) is in phase 1).
    Returns the launches of each path."""
    t = [time.perf_counter()]
    launches = {}
    launches['ga_serving'], launches['ga_training'] = phase_ga(torch, gpu)
    t.append(time.perf_counter())
    launches['fcos_serving'], launches['fcos_training'] = \
        phase_fcos(torch, gpu)
    t.append(time.perf_counter())
    launches['two_stage_trunks'], launches['x101_dcn_step'] = \
        phase_extras(torch, gpu)
    t.append(time.perf_counter())
    print('phase 13 seconds: ' + ', '.join(
        f'{k} {b - a:.1f}' for k, a, b in zip(
            ('(a) GA-Retina', '(b) FCOS', '(d) trunks'), t, t[1:]))
        + f' ({gpu})', flush=True)
    return launches


# ---------------------- phase 14: the box-only two-stage detectors
def two_stage_path(name):
    return os.path.join(ROOT, 'configs', f'{name}_1x_deepfashion2.py')


FASTER_CONFIG = two_stage_path('faster_rcnn_r50_fpn')
# by the name of their launch path: the config file, whether the frozen
# K4 + K5 prefix runs (R-50, not ResNeXt or HRNet), K6 launches a forward
# (one a FPN level a RoI stage: Faster 5, the cascade 3 x 5, C4 1), K10
# launches a forward (R50_EPILOGUES; ResNeXt-101's 33 blocks x 3; HRNet's
# 112 after a conv and 108 with an identity)
TWO_STAGE = {
    'faster_rcnn': ('faster_rcnn_r50_fpn', True, 5, R50_EPILOGUES),
    'rpn': ('rpn_r50_fpn', True, 0, R50_EPILOGUES),
    'fast_rcnn': ('fast_rcnn_r50_fpn', True, 5, R50_EPILOGUES),
    'cascade': ('cascade_rcnn_r50_fpn', True, 15, R50_EPILOGUES),
    'c4': ('faster_rcnn_r50_caffe_c4', True, 1, R50_EPILOGUES),
    'libra': ('libra_faster_rcnn_r50_fpn', True, 5, R50_EPILOGUES),
    'x101': ('faster_rcnn_x101_32x4d_fpn', False, 5, 99),
    'hrnet': ('faster_rcnn_hrnetv2p_w32', False, 5, 220),
}
TWO_STAGE_GRAD_GROUPS = ('backbone.layer2.', 'backbone.layer3.',
                         'backbone.layer4.', 'neck.', 'rpn_head.',
                         'bbox_head.')
TWO_STAGE_STAGES = ('normalize', 'backbone', 'neck', 'rpn_head',
                    'proposals', 'roi_extraction', 'box_head', 'decode')
TWO_STAGE_LOGS = ('loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox',
                  'acc')
CLI_TRAIN_IMAGES = 16
CLI_VAL_IMAGES = 4


def two_stage_launches(name, step):
    """The launches of a forward (``step`` False) or a train step of the
    path ``name``: K4 1 / K5 3 where the frozen prefix runs, K6 a RoI
    gather and, in a step, K3 as many; K9 for the RPN's proposals (not
    Fast R-CNN's, which come with the batch) and, in a forward, for the
    detections (not the RPN's, which are its ranked proposals); K10 in a
    forward alone."""
    _, prefix, k6, k10 = TWO_STAGE[name]
    per = dict(stem_pool=1, frozen_bottleneck=3) if prefix else {}
    k9 = (name != 'fast_rcnn') + (not step and name != 'rpn')
    return launch_counts(deform_sample_cols=k6,
                         deform_sample_bwd=k6 if step else 0,
                         greedy_nms=k9, bn_epilogue=0 if step else k10,
                         **per)


def jittered_proposals(rng, boxes, hw, n=ROI_COUNT):
    """(B, n, 4) Fast R-CNN proposals: boxes (B, G, 4) picked at random
    and moved by N(0, 0.1) of their size, clamped to the images (B, 2)."""
    import numpy as np
    B, G = boxes.shape[:2]
    pick = boxes[np.arange(B)[:, None], rng.randint(0, G, (B, n))]
    wh = np.tile(pick[..., 2:] - pick[..., :2], 2)
    out = pick + rng.randn(B, n, 4) * 0.1 * wh
    lim = np.tile(hw[:, None, ::-1], 2) - 1
    return np.clip(out, 0, lim).astype(np.float32), np.ones((B, n), bool)


def settle_hrnet(torch, model, batch):
    """HRNet-W32's random weights under frozen BatchNorm statistics (mean
    0, variance 1) grow its levels to an RMS of about 4e8: every RPN delta
    then leaves the image and no proposal survives. A trained model's
    levels are of order 1, so each of HRFPN's output convs (no activation)
    is divided by its level's RMS on ``batch``."""
    from kgdet_tpu_torch.ops.image import device_normalize
    image = torch.as_tensor(batch['image']).cuda()
    hw = torch.as_tensor(batch.get('img_hw', batch.get('valid_hw'))).cuda()
    with torch.no_grad():
        feats = model.features(device_normalize(image, hw))
        rms = [f.float().square().mean().sqrt().item() for f in feats]
        for conv, r in zip(model.neck.fpn_convs, rms):
            conv.conv.weight /= r
            conv.conv.bias /= r
    print('hrnet: HRFPN levels of RMS ' + ', '.join(f'{r:.3e}' for r in rms)
          + ' scaled to 1', flush=True)


def two_stage_serving(torch, gpu, name, n_reqs=SERVED):
    """Serve ``n_reqs`` requests of B images at full width through
    make_predict_fn (seeded random weights, test.score_thr 0): the launches
    of each forward, finite detections of the padded shapes (a width-3
    dummy keypoint; RPN: its ranked proposals), img/s and peak memory.
    Returns (model, cfg, requests, launches)."""
    import numpy as np

    from kgdet_tpu_torch.api import build_model, load_config, \
        make_predict_fn

    path = two_stage_path(TWO_STAGE[name][0])
    cfg = load_config(path)
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, score_thr=0.0))
    model = build_model(cfg).init_weights(SEED).eval()
    if next(model.parameters()).device.type != 'cuda':
        fail(f'{name}: build_model did not place the model on the card')
    predict = make_predict_fn(model, cfg, CANVAS)
    reqs = make_requests(n_reqs, SEED)
    if cfg.detector_type == 'fast_rcnn':
        rng = np.random.RandomState(SEED + 3)
        for r in reqs:
            xy = rng.uniform(0, 700, (B, 8, 2))
            seeds = np.concatenate([xy, xy + rng.uniform(32, 500, (B, 8, 2))],
                                   -1)
            r['proposals'], r['proposals_valid'] = jittered_proposals(
                rng, seeds, r['img_hw'])
    if name == 'hrnet':
        settle_hrnet(torch, model, reqs[0])
    predict(reqs[0])                      # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    dets, secs = serve(torch, predict, reqs)
    got = read_launches()
    want = {k: v * len(reqs) for k, v in
            two_stage_launches(name, step=False).items()}
    if got != want:
        fail(f'{name} serving: launch counts {got} != {want} for '
             f'{len(reqs)} forwards')
    m = cfg.num_proposals_test if cfg.detector_type == 'rpn' \
        else cfg.test.max_per_img
    n_valid = 0
    for d in dets:
        if not all(torch.isfinite(v).all() for v in d.values()
                   if v.is_floating_point()) or \
                tuple(d['det_bboxes'].shape) != (B, m, 5) or \
                tuple(d['det_kpts'].shape) != (B, m, 3):
            fail(f'{name} detections {[tuple(v.shape) for v in d.values()]}')
        n_valid += int(d['valid'].sum())
    if n_valid == 0:
        fail(f'{name}: no detection at score_thr 0')
    print(f'{name} serving: {os.path.relpath(path, ROOT)}, '
          f'{cfg.compute_dtype}, {n_reqs} requests x {B} images at '
          f'{CANVAS[0]}x{CANVAS[1]}, {n_valid} valid detections, launches '
          f'{got}; {B * n_reqs / secs:.2f} img/s, peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({gpu})',
          flush=True)
    return model, cfg, reqs, got


def two_stage_profile(torch, model, cfg, req, gpu, steps=2,
                      name='faster_rcnn'):
    """A Faster R-CNN-style served batch by stage under torch.profiler
    (the stages labelled around the model's parts): per stage its device
    span and busy time, the device's idle share of the window, the top
    kernels. The proposals stage holds the RPN's top-k and its NMS (K9);
    Mask R-CNN adds the mask RoIs (the refined boxes and their 14x14
    gather) and the mask head."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from kgdet_tpu_torch.models.families import two_stage_decoder
    from kgdet_tpu_torch.models.two_stage import best_class_boxes, \
        rpn_proposals
    from kgdet_tpu_torch.ops.image import device_normalize

    decode = two_stage_decoder(cfg.detector_type)
    img = torch.as_tensor(req['image']).cuda()
    img_hw = torch.as_tensor(req['img_hw']).cuda()
    sf = torch.as_tensor(req['scale_factor']).cuda()
    masks = getattr(model, 'with_mask', False)
    stages = TWO_STAGE_STAGES[:-1] + (MASK_STAGES if masks else ()) \
        + ('decode',)

    @torch.inference_mode()
    def run():
        with record_function('normalize'):
            x = device_normalize(img, img_hw)
        with record_function('backbone'):
            feats = model.backbone(x.to(model.dtype))
        with record_function('neck'):
            feats = list(model.neck(feats))
        with record_function('rpn_head'):
            rpn_outs = model.rpn_head(feats)
        with record_function('proposals'):
            props, _, valid = rpn_proposals(
                rpn_outs, model.anchors(feats), img_hw,
                max_num=model.num_proposals_test)
        with record_function('roi_extraction'):
            roi = model.roi_feats(feats, props, valid, model.roi_size)
        with record_function('box_head'):
            cls, reg = model.box_head(roi)
        fwd = dict(proposals=props, proposal_valid=valid, roi_cls=cls,
                   roi_reg=reg)
        if masks:
            with record_function('mask_rois'):
                boxes, _ = best_class_boxes(props, cls, reg)
                mfeats = model.roi_feats(feats, boxes, valid, 14)
            with record_function('mask_head'):
                logits = model.mask_head(mfeats.flatten(0, 1))
            fwd.update(refined_boxes=boxes, mask_logits=logits.reshape(
                *props.shape[:2], *logits.shape[1:]))
        with record_function('decode'):
            return decode(fwd, img_hw, sf, cfg.test, cfg.head.num_classes)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    span_ms, busy_ms, kern = stage_times(prof, stages, DeviceType.CUDA,
                                         steps)
    busy = sum(busy_ms.values())
    if busy <= 0:
        fail('the profiler saw no device time in the served batch')
    print(f'{name} profile: {steps} batches of {len(img)} at '
          f'{CANVAS[0]}x{CANVAS[1]} under torch.profiler: {wall:.3f} ms per '
          f'batch, device busy {busy:.3f} ms, idle share '
          f'{1 - busy / wall:.3f} ({gpu})', flush=True)
    print('  stage device span / busy ms per batch: ' + ', '.join(
        f'{s} {span_ms[s]:.3f}/{busy_ms[s]:.3f}' for s in stages),
        flush=True)
    print_top_kernels(kern, steps, 8)
    print_own_kernels(kern, steps, 'batch')


def hold_two_stage_against_plain(torch, model, req, name='faster_rcnn',
                                 keys=('roi_cls', 'roi_reg'),
                                 rel=MODEL_F32_REL, floor=1.0,
                                 rpn_rel=MODEL_F32_REL):
    """A Faster R-CNN-style model on its kernels against on their plain
    versions, with the proposals pinned (a rounding difference can swap
    proposals at the top-k and the NMS): the RPN's maps compared directly,
    then the RoI heads' ``keys`` fed the kernel run's proposals through
    the external-proposal input on both sides. f32 within ``rpn_rel``
    (the RPN's maps: the frozen prefix's kernels against cuDNN through the
    whole trunk) and ``rel`` (the heads' ``keys``) of each output's scale
    (its largest magnitude, at least ``floor``); bf16 error against the
    f32 plain run within BF16_RATIO x the plain bf16 run's. The model's
    dtype is restored."""
    from kgdet_tpu_torch.ops import plain_kernels
    from kgdet_tpu_torch.ops.image import device_normalize

    image = device_normalize(torch.as_tensor(req['image']).cuda(),
                             torch.as_tensor(req['img_hw']).cuda())
    img_hw = torch.as_tensor(req['img_hw']).cuda().float()
    f32, bf16 = torch.float32, torch.bfloat16
    dtype0 = model.dtype

    def run(dtype, plain, props=None):
        model.dtype = dtype
        model.external_proposals = props is not None
        kw = {} if props is None else dict(proposals=props[0],
                                           proposals_valid=props[1])
        with plain_kernels(plain):
            fwd = model(image, img_hw, train=False, **kw)
        return fwd, {k: fwd[k] for k in keys}

    def rpn_maps(fwd):
        return {f'rpn {k} level {i}': o[k][-1]
                for i, o in enumerate(fwd['rpn_outs']) for k in o}

    try:
        with torch.inference_mode():
            k32, head_k32 = run(f32, False)
            k16, head_k16 = run(bf16, False)
            p32, _ = run(f32, True)
            p16, _ = run(bf16, True)
            pinned = {dt: (fwd['proposals'], fwd['proposal_valid'])
                      for dt, fwd in ((f32, k32), (bf16, k16))}
            _, head_p32 = run(f32, True, pinned[f32])
            _, ref16 = run(f32, True, pinned[bf16])
            _, head_p16 = run(bf16, True, pinned[bf16])
    finally:
        model.dtype = dtype0
        model.external_proposals = False
    cases = [(rpn_maps(k32), rpn_maps(p32), rpn_maps(k16), rpn_maps(p16),
              rpn_maps(p32), rpn_rel),
             (head_k32, head_p32, head_k16, head_p16, ref16, rel)]
    for got32, want32, got16, plain16, ref, bound_rel in cases:
        for k in want32:
            scale = max(floor, want32[k].float().abs().max().item())
            e32 = max_err(got32[k], want32[k])
            ek, ep = max_err(got16[k], ref[k]), max_err(plain16[k], ref[k])
            print(f'{name} {k}: f32 kernels vs plain {e32:.3e}, '
                  f'{e32 / scale:.2e} of scale (bound {bound_rel:.0e}); '
                  f'bf16 vs f32 plain: kernels {ek:.3e}, plain {ep:.3e} '
                  f'(bound {BF16_RATIO} x plain)', flush=True)
            if not e32 <= bound_rel * scale:
                fail(f'{name} {k}: f32 kernel model differs by {e32:.3e}')
            if not ek <= BF16_RATIO * ep:
                fail(f'{name} {k}: bf16 kernel model err {ek:.3e} > '
                     f'{BF16_RATIO} x plain {ep:.3e}')


def two_stage_train_batches(cfg, n):
    """make_train_batches, with Fast R-CNN's proposals: the images' boxes
    jittered, ROI_COUNT an image."""
    import numpy as np
    batches = make_train_batches(n, SEED + 1, cfg.head.num_keypts)
    if cfg.detector_type == 'fast_rcnn':
        rng = np.random.RandomState(SEED + 4)
        for b in batches:
            b['proposals'], b['proposals_valid'] = jittered_proposals(
                rng, b['gt_bboxes'], b['valid_hw'].astype(np.float32))
    return batches


def two_stage_step(torch, gpu, name, free_name):
    """init_trainer on the config as shipped, one warm-up and one timed
    step at batch B in the config's dtype: the step's launches, finite
    logs (the loss terms and acc where the detector has them), every
    frozen parameter bit-equal, ``free_name`` moved; prints the step's ms
    and peak memory. Returns (model, cfg, optimizer, batches,
    launches)."""
    import math

    from kgdet_tpu_torch.api import init_trainer, load_config
    from kgdet_tpu_torch.parallel.train import frozen_param_mask

    cfg = load_config(two_stage_path(TWO_STAGE[name][0]))
    model, optimizer, train_step = init_trainer(cfg, CANVAS,
                                                steps_per_epoch=1000)
    params = dict(model.named_parameters())
    frozen = frozen_param_mask(model, cfg.backbone.frozen_stages)
    kept = {n: p.detach().clone() for n, p in params.items() if frozen[n]}
    batches = two_stage_train_batches(cfg, 2)
    if name == 'hrnet':
        settle_hrnet(torch, model, batches[0])
    start = params[free_name].detach().clone()
    torch.cuda.reset_peak_memory_stats()
    train_step(batches[0])                # warm-up: cuDNN plans, allocator
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = train_step(batches[1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = read_launches()
    want = two_stage_launches(name, step=True)
    if got != want:
        fail(f'{name} training: launch counts {got} != {want} for a step')
    vals = {k: v.item() for k, v in logs.items()}
    if not {'loss', 'grad_norm'} <= set(vals) \
            or not all(math.isfinite(v) for v in vals.values()):
        fail(f'{name} train step logs {vals}')
    if name in ('faster_rcnn', 'c4', 'libra', 'x101', 'hrnet') and \
            sorted(TWO_STAGE_LOGS) != sorted(set(vals) - {'loss',
                                                          'grad_norm'}):
        fail(f'{name} train step logs {sorted(vals)}')
    if any(not torch.equal(params[n], v) for n, v in kept.items()):
        fail(f'{name}: a frozen parameter changed')
    if torch.equal(params[free_name], start):
        fail(f'{name}: {free_name} did not move')
    print(f'{name} training: one {cfg.compute_dtype} step x {B} images at '
          f'{CANVAS[0]}x{CANVAS[1]}, launches {got}; {ms:.2f} ms a step, '
          f'{B / ms * 1e3:.2f} img/s, peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; '
          + ' '.join(f'{k} {v:.4f}' for k, v in vals.items())
          + f'; {len(kept)} frozen parameters bit-equal ({gpu})', flush=True)
    return model, cfg, optimizer, batches, got


def phase_faster_rcnn(torch, gpu):
    """(a) Faster R-CNN R-50 FPN as shipped: served, profiled by stage,
    held against its plain kernels with the proposals pinned; one bf16
    train step; the gradients of the model on K6+K3 against on their plain
    versions (the whole-model rule, the prefix the same on both sides) and
    in bf16. Returns the launches served and trained."""
    from kgdet_tpu_torch.parallel.train import make_loss_fn

    model, cfg, reqs, served = two_stage_serving(torch, gpu, 'faster_rcnn')
    two_stage_profile(torch, model, cfg, reqs[0], gpu)
    hold_two_stage_against_plain(torch, model, reqs[0])
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batches, trained = two_stage_step(
        torch, gpu, 'faster_rcnn', 'bbox_head.fc_cls.weight')
    loss_fn = make_loss_fn(model, cfg, CANVAS)

    def run(dtype, plain):
        return loss_and_grads(model, optimizer, loss_fn,
                              TWO_STAGE_GRAD_GROUPS, dtype, plain,
                              batches[0], same_prefix=True)
    ref_loss, ref = head32 = run(torch.float32, True)
    check_same_prefix_grads('K6+K3 in the RoI gather',
                            run(torch.float32, False), head32)
    check_bf16_grads(ref_loss, ref, run(torch.bfloat16, False),
                     run(torch.bfloat16, True), TWO_STAGE_GRAD_GROUPS)
    optimizer.zero_grad()
    del model, optimizer
    torch.cuda.empty_cache()
    return served, trained


FREE_NAMES = {'rpn': 'rpn_head.rpn_cls.weight',
              'cascade': 'bbox_head.2.fc_cls.weight'}


def phase_other_two_stage(torch, gpu, launches):
    """(b) The other seven box-only configs as shipped: one served batch
    and one bf16 step each (launch counts, finiteness, img/s, step ms,
    peak memory); launches by path into ``launches``."""
    for name in TWO_STAGE:
        if name == 'faster_rcnn':
            continue
        model, _, _, launches[f'{name}_serving'] = two_stage_serving(
            torch, gpu, name, n_reqs=1)
        del model
        torch.cuda.empty_cache()
        model, _, optimizer, _, launches[f'{name}_training'] = \
            two_stage_step(torch, gpu, name,
                           FREE_NAMES.get(name, 'bbox_head.fc_cls.weight'))
        del model, optimizer
        torch.cuda.empty_cache()


def cli_config(root, name, train=(), val=()):
    """The shipped config ``name`` with its data under ``root`` (the
    train / validation layout of make_eval_set), test.score_thr 0.0 and the
    fields ``train`` / ``val`` (pairs) replaced in its data configs, as a
    file that runs the shipped one."""
    path = os.path.join(root, f'{name}.py')

    def data(field, split, extra):
        return (f'    {field}=dataclasses.replace(\n'
                f'        config.{field}, ann_file={root!r} + '
                f'"/{split}-coco_style.json",\n'
                f'        img_prefix={root!r} + "/{split}/image"'
                + ''.join(f', {k}={v!r}' for k, v in extra) + '),\n')
    with open(path, 'w') as f:
        f.write('import dataclasses\nimport runpy\n'
                f'config = runpy.run_path({two_stage_path(name)!r})'
                '["config"]\nconfig = config.replace(\n'
                + data('train_data', 'train', train)
                + data('val_data', 'validation', val)
                + '    test=dataclasses.replace(config.test, '
                'score_thr=0.0))\n')
    return path


def phase_two_stage_clis(torch, gpu):
    """(c) The CLIs on synthetic PNGs: tools/train.py --validate on Faster
    R-CNN (CLI_TRAIN_IMAGES training PNGs at the shipped batch of 8, one
    epoch, CLI_VAL_IMAGES validation PNGs at batch 2; finite records, a
    checkpoint, the bbox copypaste line), tools/test.py on RPN (its
    proposal_AR_copypaste line) and on Fast R-CNN with a .pkl of jittered
    box proposals that the phase writes (the bbox copypaste line). Returns
    the training CLI's launches."""
    import math
    import pickle
    import shutil
    import tempfile

    import numpy as np

    root = tempfile.mkdtemp(prefix='kgdet_two_stage_')
    try:
        t0 = time.perf_counter()
        make_eval_set(root, SEED + 30, n_images=CLI_TRAIN_IMAGES,
                      split='train')
        images, anns = make_eval_set(root, SEED + 31,
                                     n_images=CLI_VAL_IMAGES)
        work = os.path.join(root, 'work')
        reset_launches()
        # validation at batch 2: the grouped loader cannot wrap-pad a
        # group of fewer than half a batch in test mode
        runner, printed = run_train_cli([
            cli_config(root, 'faster_rcnn_r50_fpn',
                       val=[('batch_size', 2)]),
            '--work-dir', work, '--max-epochs', '1', '--validate',
            '--log-interval', '1'])
        trained = read_launches()
        with open(os.path.join(work, 'train_log.jsonl')) as f:
            recs = [json.loads(line) for line in f]
        if runner.step < 1 or not all(
                math.isfinite(v) for r in recs for v in r.values()
                if not isinstance(v, (str, dict))):
            fail(f'Faster R-CNN tools/train.py: step {runner.step}, records '
                 f'{recs}')
        ckpts = os.listdir(os.path.join(work, 'checkpoints'))
        lines = [ln for ln in printed.splitlines()
                 if 'bbox_mAP_copypaste: ' in ln]
        if len(lines) != 1 or not ckpts:
            fail(f'Faster R-CNN tools/train.py --validate printed {lines}, '
                 f'saved {ckpts}')
        print(f'Faster R-CNN tools/train.py --validate: {runner.step} steps '
              f'on {CLI_TRAIN_IMAGES} training PNGs, {len(recs)} finite '
              f'records, checkpoints {ckpts}, launches {trained} '
              f'({time.perf_counter() - t0:.1f} s with the PNGs; {gpu})',
              flush=True)
        del runner
        torch.cuda.empty_cache()

        _, printed = run_cli([cli_config(root, 'rpn_r50_fpn'),
                              '--batch-size', '2'])
        lines = [ln for ln in printed.splitlines()
                 if ln.startswith('proposal_AR_copypaste: ')]
        ar = [float(v) for v in lines[0].split(': ', 1)[1].split()] \
            if len(lines) == 1 else []
        if len(ar) != 3 or not all(0 <= v <= 1 for v in ar):
            fail(f'RPN tools/test.py printed {lines}')
        torch.cuda.empty_cache()

        rng = np.random.RandomState(SEED + 32)
        props = []
        for im in images:
            boxes = np.asarray([[a['bbox'][0], a['bbox'][1],
                                 a['bbox'][0] + a['bbox'][2],
                                 a['bbox'][1] + a['bbox'][3]]
                                for a in anns if a['image_id'] == im['id']
                                and not a['iscrowd']], np.float32)
            p, _ = jittered_proposals(
                rng, boxes[None], np.asarray([[im['height'], im['width']]],
                                             np.float32), n=300)
            props.append(np.concatenate(
                [p[0], rng.rand(300, 1).astype(np.float32)], 1))
        pkl = os.path.join(root, 'proposals.pkl')
        with open(pkl, 'wb') as f:
            pickle.dump(props, f)
        out, printed = run_cli([cli_config(
            root, 'fast_rcnn_r50_fpn', val=[('proposal_file', pkl)]),
            '--batch-size', '2'])
        copypaste(printed, 'bbox', 12)
        if len(out['results']) != CLI_VAL_IMAGES:
            fail(f'Fast R-CNN tools/test.py: {len(out["results"])} images')
        print(f'the two-stage CLIs: {time.perf_counter() - t0:.1f} s '
              f'({gpu})', flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return trained


def phase_two_stage(torch, gpu):
    """Phase 14: (a) Faster R-CNN, (b) the other seven box-only configs,
    (c) the CLIs ((d) is in phase 1). Returns the launches of each
    path."""
    t = [time.perf_counter()]
    launches = {}
    launches['faster_rcnn_serving'], launches['faster_rcnn_training'] = \
        phase_faster_rcnn(torch, gpu)
    t.append(time.perf_counter())
    phase_other_two_stage(torch, gpu, launches)
    t.append(time.perf_counter())
    launches['faster_rcnn_train_cli'] = phase_two_stage_clis(torch, gpu)
    t.append(time.perf_counter())
    print('phase 14 seconds: ' + ', '.join(
        f'{k} {b - a:.1f}' for k, a, b in zip(
            ('(a) Faster R-CNN', '(b) seven configs', '(c) CLIs'), t,
            t[1:])) + f' ({gpu})', flush=True)
    return launches


# ------------------------------------- phase 15: the mask families, GA-RPN
# by path: the config file, the fields replaced in it, K6 a forward, K6 and
# K3 a step (K4 1 / K5 3 on each: R-50, frozen_stages=1). Mask R-CNN: the
# boxes' 5 levels and the masks' 5, a step one more for the mask targets
# (no gradient: no K3); HTC: 3 box stages x (5 levels + the semantic
# embedding's RoIs) + 5 + 1 for the masks; Grid R-CNN: the boxes' 5 and
# the grid RoIs' 5; GA-RPN: its feature adaption, one a level, and the
# boxes' 5
MASK_PATHS = {
    'mask_rcnn': ('mask_rcnn_r50_fpn', {}, 10, 11, 10),
    'ms_rcnn': ('ms_rcnn_r50_fpn', {}, 10, 11, 10),
    'htc': ('htc_r50_fpn', {}, 24, 25, 24),
    'grid_rcnn': ('faster_rcnn_r50_fpn', dict(detector_type='grid_rcnn'),
                  10, 10, 10),
    'ga_rpn': ('faster_rcnn_r50_fpn', dict(rpn_type='ga_rpn'), 10, 10, 10),
}
MASK_STAGES = ('mask_rois', 'mask_head')
MASK_GRAD_GROUPS = TWO_STAGE_GRAD_GROUPS + ('mask_head.',)
MASK_LOGS = {'mask_rcnn': ('loss_mask',), 'ms_rcnn': ('loss_mask',
                                                       'loss_mask_iou'),
             'htc': ('loss_semantic_seg', 'loss_mask_s0', 'loss_mask_s2'),
             'grid_rcnn': ('loss_grid',),
             'ga_rpn': ('loss_anchor_loc', 'loss_anchor_shape')}
MASK_FREE = {'mask_rcnn': 'mask_head.conv_logits.weight',
             'ms_rcnn': 'mask_iou_head.fc_mask_iou.weight',
             'htc': 'mask_head.2.conv_res.conv.weight',
             'grid_rcnn': 'grid_head.convs.0.conv.weight',
             'ga_rpn': 'rpn_head.conv_shape.weight'}
SEGM_IMAGES = 20
# the mask targets' map: the ground truths laid out as channels
MASK_GTS = 32
# Mask R-CNN's RPN maps, f32, its kernels against their plain versions,
# relative to each map's scale: only the frozen prefix differs (K4 / K5
# against cuDNN), and the whole f32 trunk carries it. Three runs on an
# NVIDIA H100 80GB HBM3 at 700 W read at most 1.02e-5, 8.31e-6 and
# 9.57e-6; the bound is three times the largest
MASK_RPN_F32_REL = 3e-5


def mask_config(name):
    """The shipped config of path ``name`` with its replaced fields and
    test.score_thr 0."""
    from kgdet_tpu_torch.api import load_config
    file, over, _, _, _ = MASK_PATHS[name]
    cfg = load_config(two_stage_path(file)).replace(**over)
    return cfg.replace(test=dataclasses.replace(cfg.test, score_thr=0.0))


def mask_launches(name, step):
    """K4 1 / K5 3, the path's K6 and K3; K9 for the proposals and, in a
    forward, for the detections; K10 in a forward alone."""
    _, _, fwd, k6, k3 = MASK_PATHS[name]
    return launch_counts(stem_pool=1, frozen_bottleneck=3,
                         deform_sample_cols=k6 if step else fwd,
                         deform_sample_bwd=k3 if step else 0,
                         greedy_nms=1 if step else 2,
                         bn_epilogue=0 if step else R50_EPILOGUES)


def mask_train_batches(cfg, n):
    """make_train_batches with what the mask families read: each box's
    ellipse as its ground-truth mask at 1 / mask_stride (16 an image, in
    (B, MASK_GTS, H / 4, W / 4) rasters), and for HTC a random stuff map
    of 183 classes at 1 / seg_stride with a 255 (ignored) border."""
    import numpy as np
    batches = make_train_batches(n, SEED + 5, cfg.head.num_keypts)
    rng = np.random.RandomState(SEED + 6)
    s = cfg.train_data.mask_stride
    h, w = CANVAS[0] // s, CANVAS[1] // s
    ys, xs = np.mgrid[:h, :w] + 0.5
    for b in batches:
        boxes = b['gt_bboxes'] / s
        G = boxes.shape[1]
        masks = np.zeros((B, MASK_GTS, h, w), np.float32)
        cx, cy = (boxes[..., 0] + boxes[..., 2]) / 2, \
            (boxes[..., 1] + boxes[..., 3]) / 2
        rx, ry = (boxes[..., 2] - boxes[..., 0]) / 2, \
            (boxes[..., 3] - boxes[..., 1]) / 2
        dx = (xs - cx[..., None, None]) / rx[..., None, None]
        dy = (ys - cy[..., None, None]) / ry[..., None, None]
        masks[:, :G] = dx ** 2 + dy ** 2 <= 1
        pad = np.zeros((B, MASK_GTS - G), bool)
        b.update(gt_masks=masks,
                 gt_bboxes=np.concatenate(
                     [b['gt_bboxes'], np.zeros((B, MASK_GTS - G, 4),
                                               np.float32)], 1),
                 gt_labels=np.concatenate(
                     [b['gt_labels'], np.ones((B, MASK_GTS - G), np.int32)],
                     1),
                 gt_kpts=np.concatenate(
                     [b['gt_kpts'], np.zeros((B, MASK_GTS - G,
                                              *b['gt_kpts'].shape[2:]),
                                             np.float32)], 1),
                 gt_mask=np.concatenate([b['gt_mask'], pad], 1))
        if cfg.with_semantic:
            ss = cfg.train_data.seg_stride
            seg = rng.randint(0, cfg.head.num_stuff_classes,
                              (B, CANVAS[0] // ss, CANVAS[1] // ss))
            seg[:, :4] = seg[:, -4:] = 255
            b['gt_semantic_seg'] = seg.astype(np.int32)
    return batches


def mask_serving(torch, gpu, name, n_reqs=SERVED):
    """Serve ``n_reqs`` requests of B images at full width through
    make_predict_fn (seeded random weights, test.score_thr 0): the launches
    of each forward; finite detections of the padded shapes, with mask
    probabilities (B, M, 28, 28) in [0, 1] for the mask families (and mask
    scores not above the box scores for Mask Scoring R-CNN); img/s and
    peak memory. Returns (model, cfg, requests, launches)."""
    from kgdet_tpu_torch.api import build_model, make_predict_fn

    cfg = mask_config(name)
    model = build_model(cfg).init_weights(SEED).eval()
    if next(model.parameters()).device.type != 'cuda':
        fail(f'{name}: build_model did not place the model on the card')
    predict = make_predict_fn(model, cfg, CANVAS)
    reqs = make_requests(n_reqs, SEED)
    predict(reqs[0])                      # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    dets, secs = serve(torch, predict, reqs)
    got = read_launches()
    want = {k: v * len(reqs) for k, v in mask_launches(name, False).items()}
    if got != want:
        fail(f'{name} serving: launch counts {got} != {want} for '
             f'{len(reqs)} forwards')
    m = cfg.test.max_per_img
    n_valid = 0
    for d in dets:
        if not all(torch.isfinite(v).all() for v in d.values()
                   if v.is_floating_point()) or \
                tuple(d['det_bboxes'].shape) != (B, m, 5):
            fail(f'{name} detections {[tuple(v.shape) for v in d.values()]}')
        if name in ('mask_rcnn', 'ms_rcnn', 'htc'):
            mk = d['det_masks']
            if tuple(mk.shape) != (B, m, 28, 28) or mk.min() < 0 or \
                    mk.max() > 1:
                fail(f'{name} det_masks {tuple(mk.shape)}')
        if name == 'ms_rcnn' and (d['det_mask_scores']
                                  > d['det_bboxes'][..., 4] + 1e-6).any():
            fail('ms_rcnn: a mask score above its box score')
        n_valid += int(d['valid'].sum())
    if n_valid == 0:
        fail(f'{name}: no detection at score_thr 0')
    print(f'{name} serving: {cfg.detector_type} {cfg.rpn_type}, '
          f'{cfg.compute_dtype}, {n_reqs} requests x {B} images at '
          f'{CANVAS[0]}x{CANVAS[1]}, {n_valid} valid detections, launches '
          f'{got}; {B * n_reqs / secs:.2f} img/s, peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({gpu})',
          flush=True)
    return model, cfg, reqs, got


def mask_step(torch, gpu, name):
    """init_trainer on the path's config, one warm-up and one timed step
    at batch B with masks (and stuff maps): the step's launches, finite
    logs with the family's own terms, every frozen parameter bit-equal,
    the family's own head moved; prints the step's ms and peak memory.
    Returns (model, cfg, optimizer, batches, launches)."""
    import math

    from kgdet_tpu_torch.api import init_trainer
    from kgdet_tpu_torch.parallel.train import frozen_param_mask

    cfg = mask_config(name)
    model, optimizer, train_step = init_trainer(cfg, CANVAS,
                                                steps_per_epoch=1000)
    params = dict(model.named_parameters())
    frozen = frozen_param_mask(model, cfg.backbone.frozen_stages)
    kept = {n: p.detach().clone() for n, p in params.items() if frozen[n]}
    batches = mask_train_batches(cfg, 2)
    free = MASK_FREE[name]
    start = params[free].detach().clone()
    torch.cuda.reset_peak_memory_stats()
    train_step(batches[0])                # warm-up: cuDNN plans, allocator
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logs = train_step(batches[1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = read_launches()
    want = mask_launches(name, True)
    if got != want:
        fail(f'{name} training: launch counts {got} != {want} for a step')
    vals = {k: v.item() for k, v in logs.items()}
    if not {'loss', 'grad_norm', *MASK_LOGS[name]} <= set(vals) \
            or not all(math.isfinite(v) for v in vals.values()):
        fail(f'{name} train step logs {vals}')
    if any(not torch.equal(params[n], v) for n, v in kept.items()):
        fail(f'{name}: a frozen parameter changed')
    if torch.equal(params[free], start):
        fail(f'{name}: {free} did not move')
    print(f'{name} training: one {cfg.compute_dtype} step x {B} images at '
          f'{CANVAS[0]}x{CANVAS[1]}, launches {got}; {ms:.2f} ms a step, '
          f'{B / ms * 1e3:.2f} img/s, peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; '
          + ' '.join(f'{k} {v:.4f}' for k, v in vals.items())
          + f'; {len(kept)} frozen parameters bit-equal ({gpu})', flush=True)
    return model, cfg, optimizer, batches, got


def phase_mask_rcnn(torch, gpu):
    """(a) Mask R-CNN R-50 FPN as shipped (f32): served with masks,
    profiled by stage, held against its plain kernels with the proposals
    pinned (in f32 the box head and the mask logits within 1e-5 of scale,
    the RPN's maps within MASK_RPN_F32_REL); one train step and its
    gradients on K6+K3 against their plain versions (the whole-model rule,
    the prefix the same on both sides; the plain step launches neither,
    nor K9 for its proposals).
    Returns the launches served and trained."""
    from kgdet_tpu_torch.parallel.train import make_loss_fn

    model, cfg, reqs, served = mask_serving(torch, gpu, 'mask_rcnn')
    two_stage_profile(torch, model, cfg, reqs[0], gpu, name='mask_rcnn')
    hold_two_stage_against_plain(
        torch, model, reqs[0], name='mask_rcnn',
        keys=('roi_cls', 'roi_reg', 'mask_logits'), rel=1e-5,
        rpn_rel=MASK_RPN_F32_REL)
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batches, trained = mask_step(torch, gpu,
                                                        'mask_rcnn')
    loss_fn = make_loss_fn(model, cfg, CANVAS)

    def run(plain):
        return loss_and_grads(model, optimizer, loss_fn, MASK_GRAD_GROUPS,
                              torch.float32, plain, batches[0],
                              same_prefix=True)
    kern32 = run(False)
    reset_launches()
    plain32 = run(True)
    got = read_launches()
    if got['deform_sample_cols'] or got['deform_sample_bwd'] or \
            got['greedy_nms']:
        fail(f'mask_rcnn: the plain step launched {got}')
    check_same_prefix_grads('K6+K3 in the box and mask RoI gathers and '
                            'the mask targets', kern32, plain32)
    optimizer.zero_grad()
    del model, optimizer
    torch.cuda.empty_cache()
    return served, trained


def phase_other_masks(torch, gpu, launches):
    """(b) Mask Scoring R-CNN and HTC as shipped, Grid R-CNN and the GA-RPN
    Faster R-CNN built from the Faster R-CNN config: one served batch and
    one step each (launch counts, finiteness, img/s, step ms, peak
    memory); launches by path into ``launches``."""
    for name in MASK_PATHS:
        if name == 'mask_rcnn':
            continue
        model, _, _, launches[f'{name}_serving'] = mask_serving(
            torch, gpu, name, n_reqs=1)
        del model
        torch.cuda.empty_cache()
        model, _, optimizer, _, launches[f'{name}_training'] = mask_step(
            torch, gpu, name)
        del model, optimizer
        torch.cuda.empty_cache()


def add_polygons(root, seed, split='validation'):
    """Each annotation of make_eval_set's JSON under ``root`` gains a
    polygon inside its box (an octagon of random radii), the crowd regions
    too."""
    import numpy as np
    path = os.path.join(root, f'{split}-coco_style.json')
    with open(path) as f:
        coco = json.load(f)
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 2 * np.pi, 9)[:-1]
    for a in coco['annotations']:
        x, y, w, h = a['bbox']
        r = rng.uniform(0.7, 1.0, 8)
        pts = np.stack([x + w / 2 + r * (w / 2 - 1) * np.cos(t),
                        y + h / 2 + r * (h / 2 - 1) * np.sin(t)], 1)
        a['segmentation'] = [pts.reshape(-1).round(2).tolist()]
    with open(path, 'w') as f:
        json.dump(coco, f)
    return coco


def phase_segm(torch, gpu):
    """(c) Segm evaluation on SEGM_IMAGES synthetic PNGs with polygon
    annotations: the evaluator scores the ground truth's masks as
    detections at segm AP 1.0; tools/test.py --eval bbox segm on Mask R-CNN
    (the bbox and segm copypaste lines, one segm result an image with
    detections). Returns the CLI's launches."""
    import shutil
    import tempfile

    from kgdet_tpu_torch.eval.coco import CocoIndex
    from kgdet_tpu_torch.eval.cocoeval import CocoEvaluator, ann_to_rle

    root = tempfile.mkdtemp(prefix='kgdet_segm_')
    try:
        t0 = time.perf_counter()
        make_eval_set(root, SEED + 40, n_images=SEGM_IMAGES)
        coco = add_polygons(root, SEED + 41)
        gt = CocoIndex(os.path.join(root, 'validation-coco_style.json'))
        dets = []
        for a in coco['annotations']:
            if a['iscrowd']:
                continue
            im = gt.imgs[a['image_id']]
            rle = ann_to_rle(a, im['height'], im['width'])
            dets.append({'image_id': a['image_id'],
                         'category_id': a['category_id'], 'score': 1.0,
                         'segmentation': {'size': [rle.h, rle.w],
                                          'counts': rle.to_string()
                                          .decode()}})
        ev = CocoEvaluator(gt, gt.load_results(dets), 'segm')
        ev.evaluate()
        ev.accumulate()
        stats = ev.summarize(verbose=False)
        if abs(stats['AP'] - 1.0) > 1e-9:
            fail(f'segm evaluator on the ground truth: AP {stats["AP"]}')
        print(f'segm evaluator: the ground truth of {SEGM_IMAGES} images '
              f'as {len(dets)} detections scores AP {stats["AP"]:.4f}',
              flush=True)
        reset_launches()
        out, printed = run_cli([
            cli_config(root, 'mask_rcnn_r50_fpn', val=[('batch_size', 2)]),
            '--eval', 'bbox', 'segm', '--batch-size', '2',
            '--json-out', os.path.join(root, 'out')])
        got = read_launches()
        copypaste(printed, 'bbox', 12)
        copypaste(printed, 'segm', 12)
        with open(out['files']['segm']) as f:
            segm = json.load(f)
        with_dets = {i for i, r in out['results'].items() if len(r[0])}
        if len(out['results']) != SEGM_IMAGES or \
                {r['image_id'] for r in segm} != with_dets or \
                not all(len(r) == 4 for r in out['results'].values()):
            fail(f'Mask R-CNN tools/test.py --eval segm: '
                 f'{len(out["results"])} images, {len(segm)} segm results')
        print(f'Mask R-CNN tools/test.py --eval bbox segm: {SEGM_IMAGES} '
              f'PNGs, {len(segm)} segm results, launches {got}, '
              f'{time.perf_counter() - t0:.1f} s with the PNGs ({gpu})',
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return got


def phase_masks(torch, gpu):
    """Phase 15: (a) Mask R-CNN, (b) Mask Scoring R-CNN, HTC, Grid R-CNN
    and the GA-RPN Faster R-CNN, (c) segm evaluation ((d) is in phase 1).
    Returns the launches of each path."""
    t = [time.perf_counter()]
    launches = {}
    launches['mask_rcnn_serving'], launches['mask_rcnn_training'] = \
        phase_mask_rcnn(torch, gpu)
    t.append(time.perf_counter())
    phase_other_masks(torch, gpu, launches)
    t.append(time.perf_counter())
    launches['mask_rcnn_test_cli'] = phase_segm(torch, gpu)
    t.append(time.perf_counter())
    print('phase 15 seconds: ' + ', '.join(
        f'{k} {b - a:.1f}' for k, a, b in zip(
            ('(a) Mask R-CNN', '(b) four paths', '(c) segm'), t, t[1:]))
        + f' ({gpu})', flush=True)
    return launches


UTILITY_IMAGES = 8
ROBUSTNESS = ('gaussian_noise', 'motion_blur')
ROBUSTNESS_SEVERITIES = ('1', '3')


def phase_calibration(torch, gpu):
    """(a) calibrate_frozen_bn on the cascade at full width over two
    synthetic batches of 2: every FrozenBatchNorm set, its stats finite,
    the stem's away from (0, 1); a served batch then runs K4 x1 and K5 x3
    on the refolded weights, and the calibrated prefix on K4 / K5 is held
    against the plain prefix on the same weights (f32 within F32_TOL in
    units of the output's scale, bf16 within BF16_RATIO x the plain bf16
    prefix's error). Returns the served batch's launches."""
    from kgdet_tpu_torch.api import build_model, make_predict_fn
    from kgdet_tpu_torch.models.layers import FrozenBatchNorm
    from kgdet_tpu_torch.ops import plain_kernels
    from kgdet_tpu_torch.ops.image import device_normalize
    from kgdet_tpu_torch.utils.bn_calibration import calibrate_frozen_bn

    cfg, name = config_of(CONFIG)
    cfg = cfg.replace(test=dataclasses.replace(cfg.test, score_thr=0.0))
    model = build_model(cfg).init_weights(SEED).eval()
    backbone = model.backbone
    predict = make_predict_fn(model, cfg, CANVAS)
    reqs = make_requests(3, SEED + 16)
    predict(reqs[2])                # keeps the prefix folded from (0, 1)
    kept_before = backbone._kept[0]
    bns = [m for m in model.modules() if isinstance(m, FrozenBatchNorm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = calibrate_frozen_bn(model, [r['image'] for r in reqs[:2]],
                            passes=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if n != len(bns):
        fail(f'calibration set {n} BNs, the forward reaches {len(bns)}')
    stats = torch.stack([t.abs().max() for m in bns
                         for t in (m.running_mean, m.running_var)])
    if not torch.isfinite(stats).all():
        fail('calibration: non-finite statistics')
    bn1 = backbone.bn1
    if not ((bn1.running_mean.abs().max() > 1e-3)
            and ((bn1.running_var - 1).abs().max() > 1e-3)):
        fail('calibration left the stem BN at (0, 1)')
    print(f'calibration: {name}, {n} FrozenBatchNorms over 2 batches of '
          f'{B} at {CANVAS[0]}x{CANVAS[1]} in {secs:.2f} s, largest stat '
          f'{stats.max().item():.4g}, stem BN mean |max| '
          f'{bn1.running_mean.abs().max().item():.4g} ({gpu})', flush=True)

    reset_launches()
    dets = predict(reqs[0])
    torch.cuda.synchronize()
    got = read_launches()
    want = launch_counts(deform_fused=12, stem_pool=1, frozen_bottleneck=3,
                         greedy_nms=1, bn_epilogue=R50_EPILOGUES)
    if got != want:
        fail(f'calibrated serving: launches {got} != {want}')
    if backbone._kept[0] == kept_before:
        fail('the served batch ran the prefix folded before calibration')
    if not torch.isfinite(dets['det_bboxes']).all():
        fail('calibrated serving: non-finite detections')

    x32 = device_normalize(torch.as_tensor(reqs[0]['image']).cuda())
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for plain in (False, True):
            with plain_kernels(plain):
                outs[dtype, plain] = backbone.frozen_prefix(x32.to(dtype))
    ref = outs[torch.float32, True]
    e32 = max_err(outs[torch.float32, False], ref)
    # one pass measures every BN under its upstream BNs' old stats, so the
    # random-weight trunk's layer1 output grows to ~1e5 (the JAX
    # package's single pass does the same), where an f32 ulp is ~1e-2:
    # F32_TOL's atol counts in units of the output's scale, as phase 1's
    # scaled rule does
    scale = max(1.0, ref.abs().max().item())
    atol = F32_TOL['atol'] * scale
    if not torch.allclose(outs[torch.float32, False], ref,
                          rtol=F32_TOL['rtol'], atol=atol):
        fail(f'calibrated prefix f32: K4 / K5 vs plain {e32:.3e} over atol '
             f'{atol:.3e}')
    ek = max_err(outs[torch.bfloat16, False], ref)
    ep = max_err(outs[torch.bfloat16, True], ref)
    if not ek <= BF16_RATIO * ep:
        fail(f'calibrated prefix bf16: K4 / K5 err {ek:.3e} > '
             f'{BF16_RATIO} x plain {ep:.3e}')
    print(f'calibrated prefix on K4 / K5 vs plain: output scale '
          f'{scale:.4g}, f32 {e32:.3e} (bound {atol:.3e}); bf16 vs f32 '
          f'plain: kernels {ek:.3e}, plain {ep:.3e} (bound {BF16_RATIO} x '
          f'plain); served launches {got} ({gpu})', flush=True)
    del model, outs
    torch.cuda.empty_cache()
    return got


def phase_robustness(torch, gpu, root):
    """(b) tools/test_robustness.py in-process on the cascade config over
    UTILITY_IMAGES synthetic PNGs: K1 12 / K4 1 / K5 3 / K9 1 a forward,
    the JSON with the clean set and every corruption x severity. Returns
    the CLI's launches."""
    from kgdet_tpu_torch.tools import test_robustness

    out = os.path.join(root, 'robustness.json')
    reset_launches()
    t0 = time.perf_counter()
    table, batches = test_robustness.main(
        [eval_config(root, 'robust_cfg.py'), '--corruptions', *ROBUSTNESS,
         '--severities', *ROBUSTNESS_SEVERITIES, '--out', out])
    secs = time.perf_counter() - t0
    got = read_launches()
    want = launch_counts(deform_fused=12 * batches, stem_pool=batches,
                         frozen_bottleneck=3 * batches, greedy_nms=batches,
                         bn_epilogue=R50_EPILOGUES * batches)
    if got != want or batches < 5:
        fail(f'robustness CLI: launches {got} != {want} for {batches} '
             'forwards')
    with open(out) as f:
        saved = json.load(f)
    keys = ['clean'] + [f'{c}/s{s}' for c in ROBUSTNESS
                        for s in ROBUSTNESS_SEVERITIES]
    if sorted(saved) != sorted(keys) or saved != table:
        fail(f'robustness JSON keys {sorted(saved)}, want {sorted(keys)}')
    print(f'robustness CLI: {UTILITY_IMAGES} PNGs x {len(keys)} settings, '
          f'{batches} forwards in {secs:.1f} s, launches {got}; bbox AP '
          + ', '.join(f'{k} {v["bbox"]:.4f}' for k, v in saved.items())
          + f' ({gpu})', flush=True)
    return got


PROFILE_NAMES = {
    'infer': {'K1': 'deform_fused', 'K4': 'stem_pool',
              'K5': 'bottleneck', 'K9': 'greedy_nms',
              'K10': 'bn_epilogue'},
    'train': {'K2': 'deform_split', 'K3': 'deform_bwd', 'K4': 'stem_pool',
              'K5': 'bottleneck'},
}


def phase_profile_cli(torch, gpu, root):
    """(c) tools/profile.py for both modes at batch 2, 2 steps: the Chrome
    trace read back must name the port's device kernels (kgdet::...) of
    the mode; launch counts over the warm-up and the traced steps.
    Returns the launches of each mode."""
    from kgdet_tpu_torch.tools import profile

    steps, launches = 2, {}
    per_run = {
        'infer': launch_counts(deform_fused=12, stem_pool=1,
                               frozen_bottleneck=3, greedy_nms=1,
                               bn_epilogue=R50_EPILOGUES),
        'train': launch_counts(deform_sample_split=2, deform_sample_bwd=2,
                               stem_pool=1, frozen_bottleneck=3)}
    for mode in ('infer', 'train'):
        reset_launches()
        t0 = time.perf_counter()
        path = profile.main([CONFIG, '--mode', mode, '--batch-size', str(B),
                             '--steps', str(steps), '--trace-dir',
                             os.path.join(root, f'trace_{mode}')])
        secs = time.perf_counter() - t0
        got = read_launches()
        want = {k: v * (1 + steps) for k, v in per_run[mode].items()}
        if got != want:
            fail(f'profile --mode {mode}: launches {got} != {want}')
        with open(path) as f:
            events = json.load(f)['traceEvents']
        device = {e['name'] for e in events
                  if e.get('cat') == 'kernel' and 'kgdet::' in e['name']}
        for k, pattern in PROFILE_NAMES[mode].items():
            if not any(pattern in n for n in device):
                fail(f'profile --mode {mode}: no {k} ({pattern}) among the '
                     f'device kernels {sorted(device)}')
        print(f'profile --mode {mode}: {os.path.getsize(path)} bytes of '
              f'trace, {len(events)} events, the port\'s device kernels '
              f'{sorted(short_name(n) for n in device)}, launches {got}, '
              f'{secs:.1f} s ({gpu})', flush=True)
        launches[mode] = got
        torch.cuda.empty_cache()
    return launches


def phase_flops(torch, gpu):
    """(d) tools/get_flops.py on the card at its default shape: the K1
    FLOPs it registers equal PERF.md section 6's formula over the 12
    calls. Returns the forward's launches."""
    from kgdet_tpu_torch.config import load_config
    from kgdet_tpu_torch.tools import get_flops

    reset_launches()
    out = get_flops.main([CONFIG])
    got = read_launches()
    if got != launch_counts(deform_fused=12, stem_pool=1,
                            frozen_bottleneck=3, bn_epilogue=R50_EPILOGUES):
        fail(f'get_flops: launches {got}')
    cfg = load_config(CONFIG)
    _, H, W, _ = out['shape']
    P, C = (H // 32) * (W // 32), cfg.head.feat_channels
    k1 = sum(4 * (2 * P * t * C * C + 7 * P * t * C) for t in (9, 25, 49))
    got_k1 = out['kernels']['K1 deform_conv_fused']
    if got_k1['flops'] != k1 or got_k1['calls'] != 12:
        fail(f'get_flops: K1 {got_k1} != {k1} FLOPs in 12 calls')
    print(f'get_flops: {out["shape"]}, {out["params"]} parameters, '
          f'{out["flops"] / 1e9:.2f} GFLOPs ({out["kernel_flops"] / 1e9:.2f} '
          f'in the port\'s kernels, K1 {k1 / 1e9:.3f} by the formula), '
          f'{out["kernel_bytes"] / 1e9:.4f} GB moved by the port\'s kernels '
          f'({gpu})', flush=True)
    return got


def phase_visualize(torch, gpu, root):
    """(e) tools/visualize.py on one synthetic PNG at score_thr 0: the
    output PNG is written and differs from the input on every drawn box's
    outline. Returns the launches."""
    import numpy as np

    from kgdet_tpu_torch.api import init_detector
    from kgdet_tpu_torch.data.image_io import imread
    from kgdet_tpu_torch.tools import visualize

    cfg_path = eval_config(root, 'vis_cfg.py')
    image = os.path.join(root, 'validation', 'image', '000001.png')
    out_png = os.path.join(root, 'vis.png')
    reset_launches()
    drawn, n = visualize.main([cfg_path, image, '--out', out_png,
                               '--score-thr', '0.0'])
    got = read_launches()
    if got != launch_counts(deform_fused=12, stem_pool=1,
                            frozen_bottleneck=3, greedy_nms=1,
                            bn_epilogue=R50_EPILOGUES):
        fail(f'visualize: launches {got}')
    if not os.path.exists(out_png) or \
            not np.array_equal(imread(out_png), drawn):
        fail('visualize: the output PNG is missing or not the drawing')
    src = imread(image)
    boxes = init_detector(cfg_path)(src)[0]
    h, w = src.shape[:2]
    for b in boxes:
        x1, y1, x2, y2 = (int(v) for v in b[:4])
        ring = np.zeros((h, w), bool)
        ring[max(y1, 0):min(y2, h - 1) + 1,
             [c for c in (x1, x2) if 0 <= c < w]] = True
        ring[[r for r in (y1, y2) if 0 <= r < h],
             max(x1, 0):min(x2, w - 1) + 1] = True
        if ring.any() and not (drawn[ring] != src[ring]).any():
            fail(f'visualize: box {b[:4]} left the image unchanged')
    if n != len(boxes) or n == 0:
        fail(f'visualize: {n} boxes drawn, {len(boxes)} detections')
    print(f'visualize: {n} boxes drawn on a {w}x{h} PNG, launches {got} '
          f'({gpu})', flush=True)
    return got


def phase_utilities(torch, gpu):
    """Phase 16: the utilities on the card on the main recipe at full
    width: (a) calibration, (b) the robustness CLI, (c) the profiler CLI,
    (d) the FLOP count, (e) visualization. Returns the launches of each
    path."""
    import shutil
    import tempfile

    t = [time.perf_counter()]
    launches = {'calibrated_serving': phase_calibration(torch, gpu)}
    t.append(time.perf_counter())
    root = tempfile.mkdtemp(prefix='kgdet_tools_')
    try:
        make_eval_set(root, SEED + 16, n_images=UTILITY_IMAGES)
        launches['robustness_cli'] = phase_robustness(torch, gpu, root)
        t.append(time.perf_counter())
        for mode, got in phase_profile_cli(torch, gpu, root).items():
            launches[f'profile_{mode}'] = got
        t.append(time.perf_counter())
        launches['get_flops'] = phase_flops(torch, gpu)
        t.append(time.perf_counter())
        launches['visualize'] = phase_visualize(torch, gpu, root)
        t.append(time.perf_counter())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print('phase 16 seconds: ' + ', '.join(
        f'{k} {b - a:.1f}' for k, a, b in zip(
            ('(a) calibration', '(b) robustness', '(c) profile',
             '(d) flops', '(e) visualize'), t, t[1:]))
        + f' ({gpu})', flush=True)
    return launches


PHASE_GROUPS = ('1', '2', '6', '9', '10', '11', '12', '13', '14', '15',
                '16')


def import_every_module():
    """Import every module of kgdet_tpu_torch (jax, flax and kgdet_tpu are
    blocked by then): the port needs none of them anywhere."""
    import importlib
    import pkgutil

    import kgdet_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        kgdet_tpu_torch.__path__, 'kgdet_tpu_torch.')]
    for name in names:
        importlib.import_module(name)
    print(f'imports: {len(names)} modules of kgdet_tpu_torch with jax, '
          'flax and kgdet_tpu blocked', flush=True)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--phases', default=','.join(PHASE_GROUPS),
                   help='while developing, a subset of the phase groups '
                        f'{",".join(PHASE_GROUPS)} (2 is phases 2-5, 6 is '
                        '6-8); it prints no result line. The check runs '
                        'them all, the default')
    phases = set(p.parse_args(argv).phases.split(','))
    if not phases <= set(PHASE_GROUPS):
        p.error(f'--phases takes groups of {PHASE_GROUPS}')
    # prove that nothing of JAX or of the JAX package is needed: any import
    # of them now fails
    for mod in ('jax', 'flax', 'kgdet_tpu'):
        sys.modules[mod] = None
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import_every_module()
    from kgdet_tpu_torch.ops import _build

    gpu = gpu_line()
    print(gpu, flush=True)          # name, power limit as nvidia-smi gives
    print(f'torch {torch.__version__}, cuda {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}', flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f'build: {len(logs)} sources compiled by nvcc in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    build_report(_build, logs)

    gen = torch.Generator().manual_seed(SEED)
    launches = {}                   # main path -> {kernel: launches}
    prefix = dict(stem_pool=1, frozen_bottleneck=3)
    if '1' in phases:
        kernels = phase_kernels(torch, gen)
    if '2' in phases:
        cascade_phases(torch, gpu, launches)
    if '6' in phases:
        serial_phases(torch, gpu, launches)

    # the evaluation path: dataset, loader, the CLI, TTA
    if '9' in phases:
        launches['eval'] = phase_eval(
            torch, gpu, launch_counts(deform_fused=12, greedy_nms=1,
                                      bn_epilogue=R50_EPILOGUES, **prefix))

    # the training loop: tools/train.py, resume, --validate, --checkpoint
    if '10' in phases:
        launches['train_loop'], launches['train_loop_eval'] = \
            phase_train_loop(
                torch, gpu, launch_counts(deform_sample_split=2,
                                          deform_sample_bwd=2, **prefix),
                launch_counts(deform_fused=12, greedy_nms=1,
                              bn_epilogue=R50_EPILOGUES, **prefix))

    # data parallel: two ranks on the card, one over NCCL, the learning
    # proof
    if '11' in phases:
        launches['dp_train'], launches['dp_eval'], \
            launches['learning_proof'] = phase_data_parallel(
                torch, gpu, launch_counts(deform_sample_split=2,
                                          deform_sample_bwd=2, **prefix),
                launch_counts(deform_fused=12, greedy_nms=1,
                              bn_epilogue=R50_EPILOGUES, **prefix))

    # RetinaNet, SSD300, the DCN backbone, tools/benchmark.py
    if '12' in phases:
        launches.update(phase_anchor_and_dcn(torch, gpu))

    # GA-Retina, FCOS, the two-stage configs' backbones and necks
    if '13' in phases:
        launches.update(phase_ga_fcos_and_extras(torch, gpu))

    # the box-only two-stage detectors: served, trained, their CLIs
    if '14' in phases:
        launches.update(phase_two_stage(torch, gpu))

    # the mask families and GA-RPN: served, trained, segm evaluation
    if '15' in phases:
        launches.update(phase_masks(torch, gpu))

    # the utilities: calibration, robustness, profile, FLOPs, visualize
    if '16' in phases:
        launches.update(phase_utilities(torch, gpu))

    if phases != set(PHASE_GROUPS):
        print(f'chip_smoke: phases {sorted(phases, key=int)} passed; no '
              'result line for a subset', flush=True)
        return 0
    print_result(torch, kernels, launches)
    return 0


def cascade_phases(torch, gpu, launches):
    """Phases 2 to 5: the KGDet cascade served, profiled, trained."""
    prefix = dict(stem_pool=1, frozen_bottleneck=3)
    model, cfg, req, launches['serving'] = phase_serving(
        torch, gpu, CONFIG, launch_counts(deform_fused=12, greedy_nms=1,
                                          bn_epilogue=R50_EPILOGUES,
                                          **prefix))
    phase_profile(torch, model, cfg, req, gpu)
    phase_profile(torch, model, cfg, req, gpu, plain=True)
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batch, launches['training'] = \
        phase_training(torch, gpu)
    phase_train_profile(torch, model, cfg, optimizer, batch, gpu)
    del model, optimizer
    torch.cuda.empty_cache()


def serial_phases(torch, gpu, launches):
    """Phases 6 to 8: the serial / parallel RepPoints family over the
    5-level FPN, served and trained, and the per-block backbone."""
    prefix = dict(stem_pool=1, frozen_bottleneck=3)
    serial_fwd = launch_counts(deform_fused=2 * len(SERIAL_LEVELS),
                               greedy_nms=1, bn_epilogue=R50_EPILOGUES,
                               **prefix)
    model, cfg, req, launches['serial_serving'] = phase_serving(
        torch, gpu, SERIAL_CONFIG, serial_fwd)
    phase_profile(torch, model, cfg, req, gpu)
    launches['per_block_backbone'] = phase_per_block_backbone(
        torch, model, req, gpu)
    del model
    torch.cuda.empty_cache()
    model, _, _, launches['parallel_serving'] = phase_serving(
        torch, gpu, PARALLEL_CONFIG, serial_fwd, n_reqs=1, compare=False)
    del model
    torch.cuda.empty_cache()
    model, cfg, optimizer, batch, launches['serial_training'] = \
        phase_serial_training(torch, gpu)
    phase_train_profile(torch, model, cfg, optimizer, batch, gpu)
    del model, optimizer
    torch.cuda.empty_cache()


def print_result(torch, kernels, launches):
    """The kernels line (every kernel with its launches on each main path
    and its phase 1 measurements) and the last line."""
    src = 'kgdet_tpu_torch/csrc/'
    ref = 'kgdet_tpu/ops/'
    meta = {
        'deform_fused': (src + 'deform_fused.cu',
                         ref + 'pallas_deform.py:595'),
        'deform_sample_split': (src + 'deform_split.cu',
                                ref + 'pallas_deform.py:302'),
        'deform_sample_bwd': (src + 'deform_bwd.cu',
                              ref + 'pallas_deform.py:1126'),
        'stem_pool': (src + 'prefix_mma.cuh', ref + 'pallas_stem.py:122'),
        'frozen_bottleneck': (src + 'prefix_mma.cuh',
                              ref + 'pallas_stem.py:215'),
        'deform_sample_cols': (src + 'deform_sample.cu',
                               ref + 'pallas_deform.py:177'),
        'fused_bottleneck': (src + 'prefix_mma.cuh',
                             ref + 'pallas_resblock.py:103'),
        # the JAX package's greedy NMS is a lax.scan, no Pallas kernel
        'greedy_nms': (src + 'greedy_nms.cu', 'none'),
        # XLA fuses the JAX package's BN, ReLU and sum into the conv
        'bn_epilogue': (src + 'bn_epilogue.cu', 'none'),
    }
    rows = []
    for name, (source, replaces) in meta.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        if sum(by_path.values()) == 0:
            fail(f'{name} was launched on no main path')
        rows.append({'name': name, 'route': 'cuda', 'source': source,
                     'replaces': replaces,
                     'launches': sum(by_path.values()),
                     **{f'launches_{path}': n for path, n in by_path.items()},
                     **kernels[name]})
    print(json.dumps({'kernels': rows}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
