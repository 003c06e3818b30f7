"""The frozen BatchNorms of the ResNet blocks folded into their convs when
served (kgdet_tpu_torch/models/layers.py::conv_frozen_bn).

In a forward that records no gradient, each conv of a Bottleneck or
BasicBlock runs with the FrozenBatchNorm after it folded in, on the BN's
kept (inv, shift). Held here on 1x64x96 inputs: the served trunk (R-50 with
its frozen prefix, ResNeXt-50 32x4d, R-18) against the same module with grad
enabled, which runs conv then BN as before the fold, in f32 within 1e-5 of
each stage's scale and in bf16 within twice the unfolded path's own distance
from an f32 run; the counter (``conv_frozen_bn.folded`` / ``.built``): 42
folded convs an R-50 forward, a fold built once and again only after
``load_state_dict``, ``.to()`` or an in-place write to a BN; a training
forward folds nothing and keeps its gradients bit for bit; BN calibration,
whose hooks read the BNs' inputs, folds nothing and sets what the unfolded
blocks give it.

The served blocks end each folded conv with K10's epilogue
(ops/bn_epilogue.py::bn_epilogue: the shift, the residual sum, the ReLU in
one pass; on the CPU its plain version). Held here bit for bit, in f32 and
bf16, against the served chain before K10 (the folded conv, the shift
added in place, torch.relu, out + identity) for every kind of block; 39
epilogues an R-50 forward beside its 42 folds, none in training or BN
calibration; and K10's bytes at the served batch of 8, counted on meta
tensors, against the count from the shapes.
"""
import copy
import functools

import numpy as np
import pytest
import torch

import torch.nn.functional as F

import kgdet_tpu_torch.models.resnet as resnet_mod
from kgdet_tpu_torch.models.layers import FrozenBatchNorm, _conv, \
    conv_frozen_bn
from kgdet_tpu_torch.ops import kernel_cost, plain_kernels
from kgdet_tpu_torch.ops.bn_epilogue import bn_epilogue
from kgdet_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from kgdet_tpu_torch.utils.bn_calibration import calibrate_frozen_bn

torch.set_num_threads(1)

# (ResNet kwargs, convs run folded a forward): R-50's layer1 is the frozen
# prefix (K4 / K5, folded weights of their own), so layers 2 to 4 fold 42;
# ResNeXt and R-18 take no prefix, so layer1's blocks fold too
TRUNKS = {
    'r50': (dict(depth=50, frozen_stages=1), 42),
    'x50_32x4d': (dict(depth=50, frozen_stages=1, groups=32), 52),
    'r18': (dict(depth=18, frozen_stages=1), 19),
}


def _randomize_bns(module, seed):
    """BN statistics and affine parameters away from the identity, so that
    a fold is not a no-op."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FrozenBatchNorm):
                c = m.weight.shape
                m.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                m.bias.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_mean.copy_(torch.randn(c, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return module


@functools.lru_cache(maxsize=None)
def _built(arch):
    net = ResNet(**TRUNKS[arch][0])
    net.init_weights(torch.Generator().manual_seed(0))
    return _randomize_bns(net, 100)


def _trunk(arch):
    """A fresh copy of the arch's seeded trunk (drawing R-50's weights
    takes most of a second on the CPU, a copy a few milliseconds)."""
    return copy.deepcopy(_built(arch))


def _image(dtype=torch.float32, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        1, 64, 96, 3).astype(np.float32)).to(dtype)


def _unfolded(net, x):
    """The trunk as it ran before the fold: grad enabled, conv then BN."""
    with torch.enable_grad():
        return [o.detach() for o in net(x)]


def _served(net, x, mode=torch.no_grad):
    folded, built = conv_frozen_bn.folded, conv_frozen_bn.built
    with mode():
        outs = net(x)
    return outs, conv_frozen_bn.folded - folded, conv_frozen_bn.built - built


def _assert_within_f32_order(got, want):
    """1e-5 of each stage's scale: f32 summation order only."""
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item())


@pytest.mark.parametrize('mode', [torch.no_grad, torch.inference_mode])
@pytest.mark.parametrize('arch', list(TRUNKS))
def test_served_trunk_equals_the_unfolded_one_in_f32(arch, mode):
    net, x = _trunk(arch), _image()
    got, folded, built = _served(net, x, mode)
    assert folded == built == TRUNKS[arch][1]
    _assert_within_f32_order(got, _unfolded(net, x))


@pytest.mark.parametrize('arch', list(TRUNKS))
def test_served_trunk_in_bf16_within_twice_the_unfolded_error(arch):
    net = _trunk(arch)
    ref = _unfolded(net, _image())
    x = _image(torch.bfloat16)
    got, folded, _ = _served(net, x)
    assert folded == TRUNKS[arch][1]
    plain = _unfolded(net, x)
    for g, p, r in zip(got, plain, ref):
        assert g.dtype == torch.bfloat16
        err = (g.float() - r).abs().max().item()
        assert err <= 2 * (p.float() - r).abs().max().item(), err


def test_served_r50_folds_42_convs_and_runs_no_bn_after_the_prefix(
        monkeypatch):
    """No FrozenBatchNorm.forward in layers 2 to 4 (nor in the prefix,
    which runs its own folded weights); a second forward builds no fold
    and runs the same 42 folded convs."""
    net, x = _trunk('r50'), _image()
    called = []
    real = FrozenBatchNorm.forward

    def forward(self, y):
        called.append(self)
        return real(self, y)
    monkeypatch.setattr(FrozenBatchNorm, 'forward', forward)
    first, folded, built = _served(net, x)
    assert (folded, built) == (42, 42) and called == []
    second, folded, built = _served(net, x)
    assert (folded, built) == (42, 0) and called == []
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _change(net, how):
    if how == 'load_state_dict':
        net.load_state_dict(_randomize_bns(_trunk('r50'), 7).state_dict())
    elif how == 'to':
        net.to('cpu')
    else:
        net.layer3[0].bn2.running_var.mul_(2)


@pytest.mark.parametrize('how,refolds', [
    ('load_state_dict', 42), ('to', 42), ('running_var.mul_', 1)])
def test_a_changed_bn_is_folded_again(how, refolds):
    """load_state_dict and a move or cast drop every kept pair; an in-place
    write to one BN's statistics refolds that BN alone. The refolded
    output follows the change."""
    net, x = _trunk('r50'), _image()
    before, _, _ = _served(net, x)
    _change(net, how)
    after, folded, built = _served(net, x)
    assert (folded, built) == (42, refolds)
    _assert_within_f32_order(after, _unfolded(net, x))
    moved = not all(torch.equal(a, b) for a, b in zip(before, after))
    assert moved == (how != 'to')


def _plain_block(block, x):
    """A block's forward as it was before the fold: each conv, then its
    BN module."""
    def cb(y, conv, bn, stride=1, padding=0):
        return bn(_conv(y, conv, stride, padding))
    if isinstance(block, BasicBlock):
        out = torch.relu(cb(x, block.conv1, block.bn1, block.stride, 1))
        out = cb(out, block.conv2, block.bn2, 1, 1)
    else:
        out = torch.relu(cb(x, block.conv1, block.bn1, block.c1s))
        out = torch.relu(cb(out, block.conv2, block.bn2, block.c2s, 1))
        out = cb(out, block.conv3, block.bn3)
    identity = cb(x, *block.downsample, block.stride)
    return torch.relu(out + identity)


@pytest.mark.parametrize('kind', ['bottleneck', 'resnext', 'basic'])
def test_training_forward_folds_nothing_and_keeps_its_gradients(kind):
    """Grad enabled: no fold, and the output and every gradient (conv
    weights, BN affine parameters, input) equal the conv-then-BN chain bit
    for bit."""
    torch.manual_seed(3)
    block = BasicBlock(32, 64, 2, downsample=True) if kind == 'basic' else \
        Bottleneck(64, 32, 2, downsample=True,
                   groups=8 if kind == 'resnext' else 1)
    _randomize_bns(block, 4)
    x = torch.randn(2, 32 if kind == 'basic' else 64, 12, 16)
    grads = []
    for forward in (block, lambda y: _plain_block(block, y)):
        block.zero_grad()
        xi = x.clone().requires_grad_()
        folded = conv_frozen_bn.folded
        out = forward(xi)
        (out * torch.linspace(-1, 1, out.numel()).view_as(out)).sum() \
            .backward()
        assert conv_frozen_bn.folded == folded
        grads.append([out.detach(), xi.grad] +
                     [p.grad for p in block.parameters()])
    assert all(g is not None for g in grads[0])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_training_step_of_the_r50_trunk_folds_nothing():
    net, x = _trunk('r50'), _image()
    folded, built = conv_frozen_bn.folded, conv_frozen_bn.built
    sum(o.sum() for o in net(x)).backward()
    assert (conv_frozen_bn.folded, conv_frozen_bn.built) == (folded, built)
    assert net.layer4[0].bn1.weight.grad is not None


def _conv_then_bn(y, conv, bn, stride=1, padding=0, relu=False,
                  identity=None):
    """conv_frozen_bn as the unfolded chain alone: the conv, the BN, the
    residual sum and the ReLU."""
    out = bn(_conv(y, conv, stride, padding))
    if identity is not None:
        out = out + (identity if torch.is_tensor(identity)
                     else _conv_then_bn(*identity))
    return torch.relu(out) if relu else out


def test_calibration_folds_nothing_and_sets_what_the_unfolded_blocks_give(
        monkeypatch):
    """calibrate_frozen_bn's pre-hooks keep every BN unfolded: it sets the
    same BNs, with the same statistics bit for bit, as with conv_frozen_bn
    replaced by the conv-then-BN chain, and folds nothing; the next served
    forward refolds the 42 BNs of layers 2 to 4 on the new statistics."""
    batches = [_image(seed=s).numpy() for s in (11, 12)]
    nets = [_trunk('r50'), _trunk('r50')]
    folded = conv_frozen_bn.folded
    applied = [calibrate_frozen_bn(nets[0], batches)]
    assert conv_frozen_bn.folded == folded
    monkeypatch.setattr(resnet_mod, 'conv_frozen_bn', _conv_then_bn)
    applied.append(calibrate_frozen_bn(nets[1], batches))
    monkeypatch.undo()
    assert applied == [53, 53]
    for a, b in zip(*(n.state_dict().values() for n in nets)):
        assert torch.equal(a, b)
    x = _image()
    got, folded, built = _served(nets[0], x)
    assert (folded, built) == (42, 42)
    _assert_within_f32_order(got, _unfolded(nets[0], x))


# ------------------------------------------ the epilogue of the folded convs
def _todays_fold(y, conv, bn, stride=1, padding=0):
    """A served conv before K10: the conv on its weight times bn's ``inv``,
    in y's memory format, then bn's shift added in place."""
    inv, shift = bn.scale_shift()
    w = torch.empty_like(conv.weight, dtype=y.dtype, memory_format=(
        torch.channels_last if y.is_contiguous(
            memory_format=torch.channels_last) else torch.contiguous_format))
    torch.mul(conv.weight, inv[:, None, None, None], out=w)
    return F.conv2d(y, w, stride=stride, padding=padding,
                    groups=conv.groups).add_(shift[:, None, None])


def _todays_served_block(block, x):
    """A block's served forward before K10, op for op: each conv through
    _todays_fold, torch.relu after it, ``out + identity``, torch.relu."""
    cb = _todays_fold
    if isinstance(block, BasicBlock):
        out = torch.relu(cb(x, block.conv1, block.bn1, block.stride, 1))
        out = cb(out, block.conv2, block.bn2, 1, 1)
    else:
        out = torch.relu(cb(x, block.conv1, block.bn1, block.c1s))
        if block.use_dcn:
            off = block.conv2_offset
            out = block.bn2(block.conv2(out, F.conv2d(
                out, off.weight.to(out.dtype), off.bias.to(out.dtype),
                block.c2s, 1)))
        else:
            out = cb(out, block.conv2, block.bn2, block.c2s, 1)
        out = cb(torch.relu(out), block.conv3, block.bn3)
        if block.plugin == 'gcb':
            out = block.context_block(out)
    identity = x if block.downsample is None else cb(x, *block.downsample,
                                                     block.stride)
    return torch.relu(out + identity)


# kind: (block, its input channels, K10 calls a forward)
BLOCKS = {
    'bottleneck': (lambda: Bottleneck(64, 16), 64, 3),
    'bottleneck_downsample': (lambda: Bottleneck(32, 16, downsample=True),
                              32, 3),
    'stride2': (lambda: Bottleneck(64, 16, 2, downsample=True), 64, 3),
    'caffe': (lambda: Bottleneck(64, 16, 2, downsample=True, style='caffe'),
              64, 3),
    'basic': (lambda: BasicBlock(32, 48, 2, downsample=True), 32, 2),
    'resnext': (lambda: Bottleneck(64, 32, 2, downsample=True, groups=8),
                64, 3),
    # the BN after the deformable 3x3 stays a BN: conv1 and conv3 fuse
    'dcn': (lambda: Bottleneck(64, 16, 2, downsample=True, use_dcn=True),
            64, 2),
    # the context block between bn3 and the sum: conv3 and the downsample
    # take the shift alone
    'gcb': (lambda: Bottleneck(64, 16, downsample=True, plugin='gcb'), 64,
            4),
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('kind', list(BLOCKS))
def test_served_block_equals_the_chain_before_the_epilogue(kind, dtype):
    """A served block (no gradient) through conv_frozen_bn's epilogue gives
    the served chain before K10 bit for bit, on channels-last input as the
    served trunks give it, and calls the epilogue once a fused conv."""
    make, cin, calls = BLOCKS[kind]
    torch.manual_seed(5)
    block = _randomize_bns(make(), 6)
    x = torch.randn(2, cin, 11, 14).to(
        dtype, memory_format=torch.channels_last)
    with torch.no_grad():
        want = _todays_served_block(block, x)
        with kernel_cost.tally() as t:
            got = block(x)
    assert t.kernels['K10 bn_epilogue']['calls'] == calls
    assert got.dtype == dtype and torch.equal(got, want)


EPILOGUES = {'r50': 39, 'x50_32x4d': 48, 'r18': 16}


@pytest.mark.parametrize('arch', list(TRUNKS))
def test_served_trunk_runs_an_epilogue_a_fused_conv(arch):
    """A served forward: one epilogue a conv whose ReLU or residual sum
    follows it, the downsample's shift inside its block's (R-50: 13 conv1,
    13 conv2, 13 conv3 with their identities, beside the 42 folds), the
    same on a second forward; on the CPU none of them launches K10."""
    net, x = _trunk(arch), _image()
    launches = bn_epilogue.launches
    for _ in range(2):
        with kernel_cost.tally() as t:
            _, folded, _ = _served(net, x)
        assert folded == TRUNKS[arch][1]
        assert t.kernels['K10 bn_epilogue']['calls'] == EPILOGUES[arch]
    assert bn_epilogue.launches == launches


@pytest.mark.parametrize('how', ['train_block', 'train_trunk', 'calibrate'])
def test_training_and_calibration_run_no_epilogue(how):
    """Grad enabled, or BN hooks (calibrate_frozen_bn): no fold and no
    epilogue; the op-for-op chain runs (its gradients and statistics are
    held bit for bit by the tests above)."""
    with kernel_cost.tally() as t:
        if how == 'train_block':
            block = _randomize_bns(Bottleneck(64, 16, 2, downsample=True), 4)
            block(torch.randn(2, 64, 12, 16, requires_grad=True)).sum() \
                .backward()
        elif how == 'train_trunk':
            net = _trunk('r50')
            sum(o.sum() for o in net(_image())).backward()
        else:
            calibrate_frozen_bn(_trunk('r50'), [_image(seed=11).numpy()])
    assert 'K10 bn_epilogue' not in t.kernels


def _r50_epilogue_bytes(B, H, W, itemsize):
    """K10's bytes a served R-50 forward from the shapes: layers 2 to 4
    (widths 128, 256, 512; 4, 6 and 3 blocks; the stride on the first
    block's 3x3) on the stride-4 map of an H x W canvas; conv1 and conv2
    outputs read and written once, each conv3 output, its identity and the
    result once; the f32 shifts read once (two in a block's first)."""
    h, w = -(-H // 4), -(-W // 4)
    total = 0
    for width, blocks in ((128, 4), (256, 6), (512, 3)):
        for i in range(blocks):
            total += 2 * B * h * w * width * itemsize + 4 * width   # conv1
            if i == 0:
                h, w = -(-h // 2), -(-w // 2)
            total += 2 * B * h * w * width * itemsize + 4 * width   # conv2
            total += 3 * B * h * w * 4 * width * itemsize \
                + 4 * 4 * width * (2 if i == 0 else 1)              # conv3
    return total


@pytest.mark.parametrize('canvas', [(800, 1344), (1344, 800)])
def test_epilogue_bytes_of_the_served_batch_of_8(canvas):
    """kernel_cost's K10 tally of a served R-50 batch of 8 in bf16 (the
    serve_b8 cells' trunk), run on meta tensors, equals the count from the
    shapes: 4.63 GB on either canvas, no operation counted."""
    net = ResNet(depth=50, frozen_stages=1).to('meta')
    x = torch.empty(8, *canvas, 3, device='meta', dtype=torch.bfloat16)
    with torch.no_grad(), plain_kernels(), kernel_cost.tally() as t:
        net(x)
    k10 = t.kernels['K10 bn_epilogue']
    want = _r50_epilogue_bytes(8, *canvas, 2)
    assert k10 == {'calls': 39, 'flops': 0, 'bytes': want}
    assert round(want / 1e9, 2) == 4.63
