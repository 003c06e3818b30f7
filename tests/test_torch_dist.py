"""Data-parallel training and evaluation of the port (kgdet_tpu_torch) in
two processes over gloo on the CPU, against the JAX package's ``dp`` mesh
and against the port in one process.

The processes are real: each is a ``python`` of the port alone (the tool
kgdet_tpu_torch/tools/dp_step.py, the CLIs through the launchers
tools/dist_train.sh and tools/dist_test.sh, or a few lines of the port's
API in a script), started by torchrun in a session of its own that is
killed at a time limit. No process imports JAX or this module.

The step: the tiny R-50 cascade of tests/test_torch_model.py and the serial
family of tests/test_torch_serial.py, initialized by the JAX package, take
one step on synth_batch(B=8), 4 images a process, in f32: the logs within
1e-4 relative, every summed gradient within 1e-4 of its largest value
(5e-4 on moment_transfer), the parameters after the step within the
free-running bound of tests/test_torch_train.py (0.1 of the parameter's
move), against the JAX step on ``make_mesh(2)`` and against the port's own
step in one process; the two processes' parameters, momentum, gradients
and logs bit-equal.
"""
import json
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.parallel import train as jtrain
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.parallel.dist import shard_batch
from kgdet_tpu_torch.runner import Runner
from kgdet_tpu_torch.tools import dp_step
from kgdet_tpu_torch.tools import test as ttest
from kgdet_tpu_torch.utils.convert import state_dict_from_jax
from tests.common import synth_batch
from tests.test_torch_model import _perturb as cascade_perturb
from tests.test_torch_model import tiny_r50_cfg
from tests.test_torch_runner import write_set
from tests.test_torch_serial import _perturb as serial_perturb
from tests.test_torch_serial import family_cfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (64, 96)
STEPS_PER_EPOCH = 1000          # dp_step's default
WORLD = 2
# every group of processes is killed after this many seconds
TIMEOUT = 240
CHILD_ENV = {'PYTHONPATH': ROOT, 'OMP_NUM_THREADS': '1'}


def run_group(cmd, log):
    """``cmd`` in a session of its own, its output in ``log``; the output,
    or a failure with it. The session is killed at the time limit: a
    process left waiting in a collective would otherwise hold the run."""
    env = dict(os.environ, **CHILD_ENV, PATH=os.pathsep.join(
        [os.path.dirname(sys.executable), os.environ.get('PATH', '')]))
    with open(log, 'w') as f:
        p = subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                             start_new_session=True)
        try:
            p.wait(timeout=TIMEOUT)
        finally:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    with open(log) as f:
        out = f.read()
    assert p.returncode == 0, out[-4000:]
    return out


def torchrun(args, log):
    """``torchrun --standalone --nproc_per_node=2 args`` (this Python's):
    torchrun stops every process when one fails."""
    return run_group([sys.executable, '-m', 'torch.distributed.run',
                      '--standalone', f'--nproc_per_node={WORLD}', *args],
                     log)


def launcher(name, args, log):
    """A launcher of kgdet_tpu_torch/tools, which starts torchrun."""
    return run_group(['bash', os.path.join(ROOT, 'kgdet_tpu_torch', 'tools',
                                           name), *args], log)


def script(path, text):
    """``text`` as a script file for torchrun."""
    with open(path, 'w') as f:
        f.write(text)
    return str(path)


def write_port_config(path, cfg):
    """``cfg`` (the JAX package's dataclasses) as a config file that the
    port's load_config reads into its own, field for field."""
    with open(path, 'w') as f:
        f.write('from kgdet_tpu.config import *  # noqa: F401,F403\n'
                f'config = {cfg!r}\n')
    return str(path)


def _named(tree):
    return {k: v.numpy() for k, v in
            state_dict_from_jax({'params': tree}).items()}


def family_batch(family, K):
    batch = synth_batch(canvas=CANVAS, B=8, G=4, K=K)
    if family == 'serial':
        # a crowd region an image (and a padded one) for the refine assigner
        rng = np.random.RandomState(3)
        ign = np.zeros((8, 2, 4), np.float32)
        ign[:, 0, :2] = rng.uniform(0, 40, (8, 2))
        ign[:, 0, 2:] = ign[:, 0, :2] + rng.uniform(20, 50, (8, 2))
        batch['gt_bboxes_ignore'] = ign
        batch['gt_ignore_mask'] = np.tile([True, False], (8, 1))
    return batch


# ----------------------------------------------------------------- the step
@pytest.fixture(scope='module', params=['cascade', 'serial'])
def dp(request, tmp_path_factory):
    family = request.param
    d = tmp_path_factory.mktemp(f'dp_{family}')
    if family == 'cascade':
        cfg, perturb = tiny_r50_cfg(), cascade_perturb
    else:
        cfg, perturb = family_cfg('SerialKpHead'), serial_perturb
    batch = family_batch(family, cfg.head.num_keypts)
    jmodel = jbuild_model(cfg)
    variables = perturb(init_variables(jmodel, cfg, canvas_hw=CANVAS))
    params, stats = variables['params'], variables['batch_stats']

    # the JAX package's step on a 2-device dp mesh, and its gradients
    mesh = jtrain.make_mesh(WORLD)
    tx, _ = jtrain.make_optimizer(cfg, params, STEPS_PER_EPOCH)
    grids = jtrain.build_level_geometry(cfg, CANVAS)
    with mesh:
        p = jtrain.replicate(mesh, params)
        s = jtrain.replicate(mesh, stats)
        o = jtrain.replicate(mesh, tx.init(params))
        jb = jtrain.shard_batch(mesh, batch)

        def loss_fn(p_):
            outs = jmodel.apply({'params': p_, 'batch_stats': s},
                                jb['image'])
            valids = jtrain.batch_valid_flags(cfg, CANVAS, jb['valid_hw'])
            return jtrain.compute_loss(outs, grids, valids, jb, cfg,
                                       canvas_hw=CANVAS)[0]
        jgrads = jax.jit(jax.grad(loss_fn))(p)
        jp, _, jlogs = jax.jit(jtrain.make_train_step(
            jmodel, cfg, CANVAS, tx))(p, s, o, jb)

    # the port: one process in this one, two processes of dp_step
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
    return dict(family=family, start=_named(params), jgrads=_named(jgrads),
                jparams=_named(jp),
                jlogs={k: float(v) for k, v in jlogs.items()}, one=one,
                two=[t['steps']['float32'] for t in two])


# The gradients of the trainable backbone (layer2 to layer4) lie behind
# ResNet's ReLUs: a pre-activation within rounding of zero falls on either
# side in two computations that differ in rounding, which moves single
# elements of the weight gradients upstream by up to 1e-2 of their scale
# (chip_smoke.py, MODEL_GRAD_REL). Between the port and the JAX package at
# batch 8 that happens in one process as in two (the port's one-process step
# on this batch: 1.1% of the backbone's elements beyond 1e-4, 1e-5 of them
# beyond 1e-3, the worst 8.4e-3). Those gradients are held to chip_smoke.py's
# rule for a whole model's gradients; the neck's and the head's to 1e-4.
BACKBONE = 'backbone.'
MODEL_F32_REL, MODEL_FLIP_SHARE, MODEL_GRAD_REL = 1e-3, 1e-2, 5e-2


def assert_step_close(got, logs, grads, params, start):
    """A step of the port against a reference's logs, gradients and
    parameters after the step (numpy, by torch name)."""
    assert sorted(got['logs']) == sorted(logs)
    for k, want in logs.items():
        np.testing.assert_allclose(got['logs'][k], want, rtol=1e-4,
                                   err_msg=k)
    checked, beyond, backbone = 0, 0, 0
    for name, want in grads.items():
        g = got['grads'].get(name)
        g = np.zeros_like(want) if g is None else np.asarray(g)
        scale = np.abs(want).max()
        if name.startswith(BACKBONE):
            diff = np.abs(g - want)
            assert (diff <= MODEL_GRAD_REL * scale).all(), name
            beyond += (diff > MODEL_F32_REL * scale).sum()
            backbone += diff.size
            continue
        tol = 5e-4 if name.endswith('moment_transfer') else 1e-4
        np.testing.assert_allclose(g, want, rtol=0, err_msg=name,
                                   atol=tol * scale)
        checked += scale > 0
    assert checked > 30 and backbone > 0
    assert beyond <= MODEL_FLIP_SHARE * backbone, beyond / backbone
    moved = 0
    for name, want in params.items():
        move = np.abs(want - start[name]).max()
        np.testing.assert_allclose(got['params'][name].numpy(), want,
                                   rtol=0, atol=0.1 * move + 1e-7,
                                   err_msg=name)
        moved += move > 0
    assert moved > 100


def test_two_processes_match_the_jax_dp_mesh(dp):
    """Each process's step against the JAX step on make_mesh(2)."""
    for got in dp['two']:
        assert_step_close(got, dp['jlogs'], dp['jgrads'], dp['jparams'],
                          dp['start'])


def test_two_processes_match_one_process(dp):
    """Each process's step against the port's step in one process."""
    one = dp['one']
    want_grads = {n: g.numpy() for n, g in one['grads'].items()}
    for got in dp['two']:
        assert_step_close(
            got, one['logs'], want_grads,
            {n: p.numpy() for n, p in one['params'].items()}, dp['start'])


def test_processes_are_bit_equal(dp):
    """Parameters, momentum, gradients and logs the same bits in both
    processes: one process's checkpoint is the run's."""
    a, b = dp['two']
    assert a['logs'] == b['logs']
    for part in ('params', 'momentum', 'grads'):
        assert sorted(a[part]) == sorted(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert a['launches'] == b['launches']


# ------------------------------------------------------------------- gather
GATHER = '''
import sys
import numpy as np
import torch
from kgdet_tpu_torch.eval_loop import gather_results_across_processes
from kgdet_tpu_torch.parallel.dist import init_distributed, world
init_distributed('cpu')
rank = world()[0]
rng = np.random.RandomState(0)
parts = [
    {1: (rng.randn(3, 5).astype(np.float32), np.arange(3))},
    {2: (rng.randn(7, 5).astype(np.float32), np.arange(7)),
     3: (np.zeros((0, 5), np.float32), np.zeros((0,), np.int64))},
]
merged = gather_results_across_processes(parts[rank])
torch.save({k: [torch.from_numpy(a) for a in v] for k, v in merged.items()},
           sys.argv[1] + f'/rank{rank}.pt')
'''


def test_gather_results_across_processes(tmp_path):
    """tests/test_mesh_equivalence.py's gather in real processes: every
    process holds every process's results."""
    torchrun([script(tmp_path / 'gather.py', GATHER), str(tmp_path)],
             tmp_path / 'gather.log')
    rng = np.random.RandomState(0)
    want = {1: rng.randn(3, 5).astype(np.float32),
            2: rng.randn(7, 5).astype(np.float32)}
    for r in range(WORLD):
        got = torch.load(tmp_path / f'rank{r}.pt', weights_only=True)
        assert sorted(got) == [1, 2, 3]
        for k, v in want.items():
            np.testing.assert_array_equal(got[k][0].numpy(), v)
        assert tuple(got[3][0].shape) == (0, 5)


def test_shard_batch_splits_and_refuses_a_remainder():
    batch = synth_batch(B=8)
    batch['seed'] = np.int32(7)
    parts = [shard_batch(batch, r, 4) for r in range(4)]
    for k, v in batch.items():
        if np.ndim(v):
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), v)
    assert all(p['seed'] == 7 for p in parts)
    with pytest.raises(ValueError, match='not divisible by 3'):
        shard_batch(batch, 0, 3)


# ------------------------------------------------------------------- runner
RUNNER = '''
import sys
import torch
from kgdet_tpu_torch import eval_loop
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.parallel.dist import init_distributed, world
from kgdet_tpu_torch.runner import Runner
from kgdet_tpu_torch.utils.checkpoint import CheckpointManager

cfg_path, work, out = sys.argv[1:4]
init_distributed('cpu')
rank = world()[0]
writes = {'checkpoints': 0, 'json': 0}
save, dump = CheckpointManager.save, eval_loop.write_results


def counted_save(*a, **kw):
    writes['checkpoints'] += 1
    return save(*a, **kw)


def counted_dump(*a, **kw):
    writes['json'] += 1
    return dump(*a, **kw)


CheckpointManager.save, eval_loop.write_results = counted_save, counted_dump


def state_of(r):
    opt = r.optimizer.state_dict()
    return {'model': {k: v.clone() for k, v in r.model.state_dict().items()},
            'momentum': {k: v.clone() for k, v in opt['momentum'].items()},
            'step_count': opt['step_count']}


cfg = load_config(cfg_path)
r1 = Runner(cfg, work_dir=work, log_interval=2, n_devices=2, device='cpu')
r1.setup()
start = state_of(r1)
r1.train_epoch()
r1.save_checkpoint(wait=True)
saved = state_of(r1)
r2 = Runner(cfg, work_dir=work, log_interval=2, device='cpu')
r2.setup(resume=True)
resumed = state_of(r2)
progress = (r1.steps_per_epoch, r1.step, r2.step, r2.epoch)
r2.train_epoch()
stats = r2.evaluate(verbose=False)
torch.save({'start': start, 'saved': saved, 'resumed': resumed,
            'progress': progress, 'stats': stats, 'writes': writes,
            'step2': r2.step}, f'{out}/rank{rank}.pt')
'''


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp('dp_runner')
    cfg_path = write_set(str(d), landscape_only=False)
    work = d / 'work'
    torchrun([script(d / 'runner.py', RUNNER), cfg_path, str(work), str(d)],
             d / 'runner.log')
    got = [torch.load(d / f'rank{r}.pt', weights_only=True)
           for r in range(WORLD)]
    return dict(d=d, cfg_path=cfg_path, work=work, got=got)


def assert_states_equal(a, b):
    assert a['step_count'] == b['step_count']
    for part in ('model', 'momentum'):
        assert sorted(a[part]) == sorted(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


def test_two_process_runner_saves_once_and_resumes_on_both(runs):
    """tests/test_runner.py's flow at n_devices=2 in two processes: 8
    images at 1 a process a step make 4 steps an epoch; process 0 alone
    writes the one checkpoint set and both processes resume it, equal to
    what was saved and to each other."""
    a, b = runs['got']
    for g in (a, b):
        assert g['progress'] == (4, 4, 4, 1) and g['step2'] == 8
        assert_states_equal(g['resumed'], g['saved'])
        assert g['saved']['step_count'] == 4
    assert_states_equal(a['start'], b['start'])
    assert_states_equal(a['saved'], b['saved'])
    assert_states_equal(a['resumed'], b['resumed'])
    moved = sum(not torch.equal(a['saved']['model'][k], a['start']['model'][k])
                for k in a['start']['model'])
    assert moved > 50
    assert (a['writes']['checkpoints'], b['writes']['checkpoints']) == (1, 0)
    ckpt_dir = runs['work'] / 'checkpoints'
    assert sorted(os.listdir(ckpt_dir)) == ['4']
    assert os.listdir(ckpt_dir / '4') == ['checkpoint.pt']
    saved = torch.load(ckpt_dir / '4' / 'checkpoint.pt', weights_only=True)
    for k, v in a['saved']['model'].items():
        assert torch.equal(saved['model'][k], v), k
    with open(runs['work'] / 'train_log.jsonl') as f:
        recs = [json.loads(line) for line in f]
    # process 0 logs every second step of its own: 2 records an epoch
    assert [r['iter'] for r in recs if r['mode'] == 'train'] == [2, 4, 2, 4]


def test_two_process_evaluation_scores_once_with_equal_stats(runs):
    """Both processes score the gathered results to the same stats;
    process 0 alone writes the JSON files, once."""
    a, b = runs['got']
    assert a['stats'] == b['stats']
    assert sorted(a['stats']) == ['bbox', 'keypoints']
    assert all(np.isfinite(v) for s in a['stats'].values()
               for v in s.values())
    assert (a['writes']['json'], b['writes']['json']) == (1, 0)
    for kind in ('bbox', 'keypoints'):
        assert os.path.exists(runs['work'] / f'eval_epoch2.{kind}.json')


def test_runner_refuses_a_count_that_is_not_the_world(runs, monkeypatch):
    """n_devices other than the world raises, naming torchrun; a global
    batch that the world does not divide raises in setup."""
    import kgdet_tpu_torch.runner as runner_mod
    cfg = load_config(runs['cfg_path'])
    work = str(runs['d'] / 'x')
    for n in (2, 4):
        with pytest.raises(ValueError, match='torchrun'):
            Runner(cfg, work_dir=work, n_devices=n, device='cpu')
    Runner(cfg, work_dir=work, n_devices=1, device='cpu')
    monkeypatch.setattr(runner_mod, 'world', lambda: (0, 3))
    r = Runner(cfg, work_dir=work, n_devices=3, device='cpu')
    with pytest.raises(ValueError, match='not divisible by 3 processes'):
        r.setup()


# --------------------------------------------------------------------- CLIs
def _copypaste(out, iou_type):
    lines = [ln for ln in out.splitlines()
             if ln.startswith(f'{iou_type}_mAP_copypaste: ')]
    assert len(lines) == 1, out[-3000:]
    return [float(v) for v in lines[0].split(': ', 1)[1].split()]


def _by_image(path):
    with open(path) as f:
        dets = json.load(f)
    out = {}
    for det in dets:
        out.setdefault(det['image_id'], []).append(det)
    return out


def test_test_cli_in_two_processes_matches_one(runs, tmp_path, capsys):
    """tools/dist_test.sh CONFIG 2: every image's detections exactly once
    (as many as one process finds, within 1e-4 relative in f32) and the
    copypaste stats within 1e-4 of one process's, printed once."""
    one = ttest.main([runs['cfg_path'], '--device', 'cpu', '--json-out',
                      str(tmp_path / 'one')])
    one_out = capsys.readouterr().out
    out = launcher('dist_test.sh', [
        runs['cfg_path'], '2', '--device', 'cpu', '--json-out',
        str(tmp_path / 'two')], tmp_path / 'two.log')
    for kind, n in (('bbox', 12), ('keypoints', 10)):
        want = _copypaste(one_out, kind)
        got = _copypaste(out, kind)
        assert len(got) == n
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=kind)
        w, g = (_by_image(tmp_path / f'{p}.{kind}.json')
                for p in ('one', 'two'))
        assert sorted(g) == sorted(w) == sorted(one['results'])
        for img, dets in w.items():
            assert len(g[img]) == len(dets), (kind, img)
            for a, b in zip(g[img], dets):
                assert a['category_id'] == b['category_id']
                np.testing.assert_allclose(
                    [a['score'], *a.get('bbox', []), *a.get('keypoints', [])],
                    [b['score'], *b.get('bbox', []), *b.get('keypoints', [])],
                    rtol=1e-4, atol=1e-4, err_msg=f'{kind} {img}')
    assert out.count('[test] wrote') == 1


def test_train_cli_in_two_processes(runs, tmp_path):
    """tools/dist_train.sh CONFIG 2 for an epoch: 4 steps of 1 image a
    process, process 0's log and checkpoint, printed once."""
    work = tmp_path / 'w'
    out = launcher('dist_train.sh', [
        runs['cfg_path'], '2', '--device', 'cpu', '--work-dir', str(work),
        '--max-epochs', '1', '--log-interval', '2'], tmp_path / 'train.log')
    assert out.count('[train] 8 images, 4 steps/epoch, device cpu') == 1
    assert out.count('[dist] process group: gloo, 2 process(es)') == 1
    assert sorted(os.listdir(work / 'checkpoints')) == ['4']
    with open(work / 'train_log.jsonl') as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 2 and all(np.isfinite(r['loss']) for r in recs)


def test_distributed_without_torchrun_raises(runs):
    env = {k: v for k, v in os.environ.items()
           if k not in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')}
    code = ('from kgdet_tpu_torch.tools.train import main\n'
            f"main([{runs['cfg_path']!r}, '--distributed', '--device', "
            "'cpu'])\n")
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         env=dict(env, **CHILD_ENV), capture_output=True,
                         text=True, timeout=TIMEOUT)
    assert res.returncode != 0
    assert 'runs under torchrun' in res.stderr
