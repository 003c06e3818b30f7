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
"""
import copy
import functools

import numpy as np
import pytest
import torch

import kgdet_tpu_torch.models.resnet as resnet_mod
from kgdet_tpu_torch.models.layers import FrozenBatchNorm, _conv, \
    conv_frozen_bn
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
    monkeypatch.setattr(resnet_mod, 'conv_frozen_bn',
                        lambda y, conv, bn, stride=1, padding=0:
                        bn(_conv(y, conv, stride, padding)))
    applied.append(calibrate_frozen_bn(nets[1], batches))
    monkeypatch.undo()
    assert applied == [53, 53]
    for a, b in zip(*(n.state_dict().values() for n in nets)):
        assert torch.equal(a, b)
    x = _image()
    got, folded, built = _served(nets[0], x)
    assert (folded, built) == (42, 42)
    _assert_within_f32_order(got, _unfolded(nets[0], x))
