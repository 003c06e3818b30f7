"""Data-parallel training of a two-stage detector in the port: two gloo
processes on the CPU (kgdet_tpu_torch/tools/dp_step.py under torchrun, as
tests/test_torch_dist.py runs them) against one process on the same
global batch.

Tiny Faster R-CNN (tests/test_two_stage.py's ResNet-18 config) with the
JAX package's weights, one f32 step on synth_batch(B=4), 2 images a
process. The samplers draw by each image's index in the global batch
(core/two_stage_loss.py::sampler_draw), so both runs sample the same
anchors and RoIs: the summed logs within 1e-4 relative, every gradient by
the whole-model rule of ROADMAP "Standing findings" (the RPN head's and
the box head's within 1e-4 of scale in every element), the parameters
after the step within 0.1 of their move; the two processes bit-equal.
"""
import numpy as np
import pytest
import torch

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.tools import dp_step
from kgdet_tpu_torch.utils.convert import state_dict_from_jax
from tests.common import synth_batch
from tests.test_torch_dist import CANVAS, WORLD, torchrun, \
    write_port_config
from tests.test_torch_two_stage_models import _perturb
from tests.test_two_stage import frcnn_cfg

torch.set_num_threads(1)
MODEL_F32_REL, MODEL_FLIP_SHARE, MODEL_GRAD_REL = 1e-3, 1e-2, 5e-2
HEADS = ('rpn_head.', 'bbox_head.')


@pytest.fixture(scope='module')
def dp(tmp_path_factory):
    d = tmp_path_factory.mktemp('dp_faster_rcnn')
    cfg = frcnn_cfg()
    variables = _perturb(init_variables(jbuild_model(cfg), cfg,
                                        canvas_hw=CANVAS))
    batch = synth_batch(canvas=CANVAS, B=4, G=4, K=cfg.head.num_keypts)
    state = state_dict_from_jax(variables)
    torch.save(state, d / 'state.pt')
    np.savez(d / 'batch.npz', **batch)
    cfg_path = write_port_config(d / 'cfg.py', cfg)
    one = dp_step.take_step(load_config(cfg_path), state, batch, 'cpu',
                            torch.float32)
    torchrun(['-m', 'kgdet_tpu_torch.tools.dp_step', cfg_path, '--state',
              str(d / 'state.pt'), '--batch', str(d / 'batch.npz'), '--out',
              str(d / 'out'), '--device', 'cpu'], d / 'dp_step.log')
    two = [torch.load(d / 'out' / f'rank{r}.pt', weights_only=True)
           for r in range(WORLD)]
    assert [t['world'] for t in two] == [WORLD] * WORLD
    return dict(one=one, two=[t['steps']['float32'] for t in two],
                start=state)


def test_two_processes_match_one_process(dp):
    """Each process's step against one process's on the whole batch."""
    one = dp['one']
    assert sorted(one['logs']) == ['acc', 'grad_norm', 'loss', 'loss_bbox',
                                   'loss_cls', 'loss_rpn_bbox',
                                   'loss_rpn_cls']
    assert one['logs']['loss_cls'] > 0 and one['logs']['acc'] > 0
    for got in dp['two']:
        for k, want in one['logs'].items():
            np.testing.assert_allclose(got['logs'][k], want, rtol=1e-4,
                                       err_msg=k)
        beyond = total = checked = 0
        for name, want in one['grads'].items():
            want = want.numpy()
            g = got['grads'][name].numpy()
            scale = np.abs(want).max()
            if not scale:
                assert not g.any(), name
                continue
            diff = np.abs(g - want) / scale
            assert diff.max() <= MODEL_GRAD_REL, (name, diff.max())
            if name.startswith(HEADS):
                assert diff.max() <= 1e-4, (name, diff.max())
            beyond += int((diff > MODEL_F32_REL).sum())
            total += diff.size
            checked += 1
        assert checked > 30
        assert beyond <= MODEL_FLIP_SHARE * total, beyond / total
        for name, want in one['params'].items():
            move = (want - dp['start'][name]).abs().max().item()
            np.testing.assert_allclose(got['params'][name].numpy(),
                                       want.numpy(), rtol=0,
                                       atol=0.1 * move + 1e-7, err_msg=name)


def test_processes_are_bit_equal(dp):
    """Parameters, momentum, gradients and logs the same bits in both
    processes."""
    a, b = dp['two']
    assert a['logs'] == b['logs']
    for part in ('params', 'momentum', 'grads'):
        assert sorted(a[part]) == sorted(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
