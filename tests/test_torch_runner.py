"""The port's training loop (kgdet_tpu_torch.runner, utils/checkpoint.py,
tools/train.py, tools/analyze_logs.py, tools/publish_model.py and
``--checkpoint`` of init_detector and tools/test.py) on the CPU.

Synthetic COCO-style sets of tests/test_data.py, written as PNGs
(tests/test_torch_eval.py::make_eval_set), train the tiny R-50 KGDet model
of tests/test_torch_model.py with its 294-keypoint head (CONFIG_TEXT, shared
with the GPU tests of tests/test_torch_gpu.py). The flow of
tests/test_runner.py (train, save, resume in a fresh Runner, train,
evaluate) is asserted as that test asserts it; a resumed run is held bit
for bit against an uninterrupted one; the JAX package's Runner
(``n_devices=1``), started from the same variables, gives the same epoch
of batches and the same first log record (losses within rtol 1e-3: the tiny
step is chaotic after a few updates, so no later record is compared). The
checkpoint format, the optimizer's state and the CLIs are checked on the
way.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip('cv2')

from kgdet_tpu.api import build_model as jbuild_model
from kgdet_tpu.api import init_variables
from kgdet_tpu.config import OptimConfig
from kgdet_tpu.config import load_config as jload_config
from kgdet_tpu.runner import Runner as JRunner
from kgdet_tpu.tools import analyze_logs as janalyze
from kgdet_tpu.utils.torch_convert import convert_state_dict
from kgdet_tpu_torch.api import Detector, build_model, init_detector
from kgdet_tpu_torch.config import load_config
from kgdet_tpu_torch.data.loader import DataLoader, grouped_batch_indices
from kgdet_tpu_torch.eval_loop import run_inference
from kgdet_tpu_torch.parallel.train import make_optimizer
from kgdet_tpu_torch.runner import Runner
from kgdet_tpu_torch.tools import analyze_logs, publish_model
from kgdet_tpu_torch.tools import test as ttest
from kgdet_tpu_torch.tools import train as ttrain
from kgdet_tpu_torch.utils import checkpoint as ckpt
from kgdet_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_data import assert_same
from tests.test_torch_eval import make_eval_set
from tests.test_torch_gpu import CONFIG_TEXT
from tests.test_torch_model import tiny_r50_cfg

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INTERVAL = 2

def write_set(d, landscape_only):
    """8 PNG images (4 landscape and 4 portrait, or all landscape with one
    canvas) and a config training on them: 4 steps of 2 an epoch."""
    ann = make_eval_set(d, n_images=8, landscape_only=landscape_only)
    canvases = ((64, 96),) if landscape_only else ((64, 96), (96, 64))
    path = os.path.join(d, f'cfg_{int(landscape_only)}.py')
    with open(path, 'w') as f:
        f.write(CONFIG_TEXT.format(ann=ann, prefix=d, canvases=canvases))
    return path


def records(work_dir, mode='train'):
    with open(os.path.join(work_dir, 'train_log.jsonl')) as f:
        return [r for r in map(json.loads, f) if r['mode'] == mode]


def state_of(runner):
    """Parameters, buffers and optimizer state of a runner, cloned."""
    opt = runner.optimizer.state_dict()
    return {'model': {k: v.clone() for k, v in
                      runner.model.state_dict().items()},
            'momentum': {k: v.clone() for k, v in opt['momentum'].items()},
            'step_count': opt['step_count']}


def assert_states_equal(a, b):
    assert a['step_count'] == b['step_count']
    for part in ('model', 'momentum'):
        assert sorted(a[part]) == sorted(b[part])
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """On the mixed set: run A trains 2 epochs without a break; run B
    trains 1 epoch and saves, a fresh Runner resumes it, trains epoch 2,
    saves and evaluates."""
    d = str(tmp_path_factory.mktemp('torch_runner'))
    cfg_path = write_set(d, landscape_only=False)
    cfg = load_config(cfg_path)
    work_a, work_b = os.path.join(d, 'a'), os.path.join(d, 'b')
    a = Runner(cfg, work_dir=work_a, log_interval=INTERVAL, device='cpu')
    a.setup()
    a.run(max_epochs=2)

    b1 = Runner(cfg, work_dir=work_b, log_interval=INTERVAL, device='cpu')
    b1.setup()
    start = state_of(b1)
    b1.train_epoch()
    b1.save_checkpoint(wait=True)
    saved = state_of(b1)
    b2 = Runner(cfg, work_dir=work_b, log_interval=INTERVAL, device='cpu')
    b2.setup(resume=True)
    resumed = dict(state_of(b2), step=b2.step, epoch=b2.epoch)
    b2.train_epoch()
    b2.save_checkpoint()
    stats = b2.evaluate(verbose=False)
    return dict(d=d, cfg_path=cfg_path, cfg=cfg, a=a, b1=b1, b2=b2,
                start=start, saved=saved, resumed=resumed, stats=stats,
                work_a=work_a, work_b=work_b)


# --------------------------------------------------------------- the loop
def test_runner_train_checkpoint_resume_eval(runs):
    """What tests/test_runner.py asserts of the JAX package's Runner."""
    b1, b2, work = runs['b1'], runs['b2'], runs['work_b']
    assert b1.steps_per_epoch >= 2
    assert b1.step == b1.steps_per_epoch
    recs = records(work)
    assert any(np.isfinite(r['loss']) for r in recs)
    assert runs['resumed']['step'] == b1.step
    assert runs['resumed']['epoch'] == 1
    assert b2.step == 2 * b1.steps_per_epoch
    stats = runs['stats']
    assert 'bbox' in stats and 'keypoints' in stats
    assert np.isfinite(stats['bbox']['AP'])
    assert np.isfinite(stats['keypoints']['AP'])
    with open(os.path.join(work, 'eval_epoch2.bbox.json')) as f:
        dets = json.load(f)
    assert dets and {'image_id', 'bbox', 'score', 'category_id'} <= \
        set(dets[0])
    assert os.path.isfile(os.path.join(work, 'eval_epoch2.keypoints.json'))
    # every record finite, one a log interval, the JAX logger's keys
    assert len(recs) == 2 * b1.steps_per_epoch // INTERVAL
    for r in recs:
        assert all(np.isfinite(v) for v in r.values()
                   if not isinstance(v, str)), r
        assert r['lr'] > 0 and r['imgs_per_sec'] > 0
    # the frozen prefix did not move, a free parameter did
    model = b2.model.state_dict()
    frozen = 'backbone.layer1.0.conv1.weight'
    free = 'bbox_head.kp_rep_block_3.cls_out.weight'
    assert torch.equal(model[frozen], runs['start']['model'][frozen])
    assert not torch.equal(model[free], runs['start']['model'][free])


def test_resume_is_bit_for_bit(runs):
    """1 epoch + save + a fresh runner's resume + 1 epoch gives the
    parameters, buffers, optimizer state and log records of epoch 2 of an
    uninterrupted 2-epoch run, bit for bit on the CPU; the resumed runner
    starts from exactly what was saved."""
    assert_states_equal(runs['resumed'], runs['saved'])
    assert_states_equal(state_of(runs['b2']), state_of(runs['a']))
    assert runs['b2'].step == runs['a'].step
    assert runs['b2'].optimizer.step_count == runs['a'].step
    got = records(runs['work_b'])[-2:]
    want = records(runs['work_a'])[-2:]
    for g, w in zip(got, want):
        g.pop('imgs_per_sec')
        w.pop('imgs_per_sec')
        assert g == w


def test_checkpoint_format(runs):
    """torch.load(weights_only=True) takes it; every tensor is on the CPU;
    the model's names are the reference's, which torch_convert maps with
    nothing skipped; the optimizer's buffers are keyed by the free
    parameters' names."""
    path = os.path.join(runs['work_b'], 'checkpoints', '8', ckpt.FILE)
    state = torch.load(path, map_location='cpu', weights_only=True)
    assert sorted(state) == ['epoch', 'model', 'optimizer', 'step']
    assert state['step'] == 8 and state['epoch'] == 2
    opt = state['optimizer']
    assert opt['type'] == 'sgd' and opt['step_count'] == 8
    tensors = list(state['model'].values()) + list(opt['momentum'].values())
    assert all(t.device.type == 'cpu' for t in tensors)
    model = runs['b2'].model
    assert sorted(state['model']) == sorted(model.state_dict())
    assert sorted(opt['momentum']) == sorted(runs['b2'].optimizer.names)
    _, _, skipped = convert_state_dict(state['model'])
    assert skipped == []
    assert sorted(os.listdir(os.path.join(runs['work_b'], 'checkpoints'))) \
        == ['4', '8']


def test_latest_step_ignores_partial_files(tmp_path):
    """A save killed before its os.replace leaves a temporary file, or a
    step directory without its file: neither counts as a step."""
    mgr = ckpt.CheckpointManager(str(tmp_path / 'checkpoints'))
    assert mgr.latest_step() is None
    mgr.save(16, {'step': 16, 'w': torch.ones(3)})
    os.makedirs(tmp_path / 'checkpoints' / '32')
    with open(tmp_path / 'checkpoints' / '32' / 'checkpoint.pt.tmp-1',
              'wb') as f:
        f.write(b'partial')
    os.makedirs(tmp_path / 'checkpoints' / '48')
    assert mgr.latest_step() == 16
    assert mgr.all_steps() == [16]
    assert torch.equal(mgr.restore(16)['w'], torch.ones(3))
    mgr.save(32, {'step': 32})
    assert mgr.latest_step() == 32
    assert sorted(os.listdir(tmp_path / 'checkpoints' / '32')) == \
        ['checkpoint.pt', 'checkpoint.pt.tmp-1']


def test_max_to_keep_prunes(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (4, 8, 12, 16):
        mgr.save(step, {'step': step})
    assert mgr.all_steps() == [12, 16]
    assert sorted(os.listdir(tmp_path)) == ['12', '16']
    mgr.close()


@pytest.mark.parametrize('opt_type', ['sgd', 'adam'])
def test_optimizer_state_round_trip(opt_type):
    """An SGDOptimizer loaded from another's state_dict (through a
    torch.save / weights_only load) takes the same next step, bit for bit,
    and refuses a state of the other type."""
    cfg = tiny_r50_cfg().replace(optim=OptimConfig(
        type=opt_type, bias_lr_mult=2.0, bias_decay_mult=0.0,
        warmup_iters=3))
    gen = torch.Generator().manual_seed(0)

    def grads(model):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)

    one = build_model(cfg, device='cpu').init_weights(0)
    opt1, _ = make_optimizer(cfg, one, 10)
    for _ in range(2):
        grads(one)
        opt1.step()
    buf = io.BytesIO()
    torch.save(ckpt.to_cpu(opt1.state_dict()), buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    two = build_model(cfg, device='cpu')
    two.load_state_dict(one.state_dict())
    opt2, _ = make_optimizer(cfg, two, 10)
    opt2.load_state_dict(saved)
    assert opt2.step_count == 2
    g = [torch.randn(p.shape, generator=gen) for p in one.parameters()]
    for model, opt in ((one, opt1), (two, opt2)):
        for p, gi in zip(model.parameters(), g):
            p.grad = gi.clone()
        opt.step()
    for (n, a), b in zip(one.named_parameters(), two.parameters()):
        assert torch.equal(a, b), n
    other = dict(saved, type='adam' if opt_type == 'sgd' else 'sgd')
    with pytest.raises(ValueError, match='does not load'):
        opt2.load_state_dict(other)


# --------------------------------------------------------- the JAX Runner
@pytest.fixture(scope='module')
def jax_pair(tmp_path_factory):
    """The JAX Runner (n_devices=1) and the port's on the landscape set,
    from the same variables: epoch 0's batches of both loaders, then one
    epoch each."""
    d = str(tmp_path_factory.mktemp('runner_parity'))
    cfg_path = write_set(d, landscape_only=True)
    jcfg, tcfg = jload_config(cfg_path), load_config(cfg_path)
    variables = init_variables(jbuild_model(jcfg), jcfg)
    jr = JRunner(jcfg, work_dir=os.path.join(d, 'j'), n_devices=1,
                 log_interval=INTERVAL)
    jr.setup(init_from_variables=variables)
    tr = Runner(tcfg, work_dir=os.path.join(d, 't'), log_interval=INTERVAL,
                device='cpu')
    tr.setup(init_state_dict=state_dict_from_jax(variables))
    batches = []
    for r in (jr, tr):
        r.train_loader.set_epoch(0)
        batches.append(list(r.train_loader))
    jr.train_epoch()
    tr.train_epoch()
    return dict(jr=jr, tr=tr, batches=batches)


def test_steps_and_batches_match_jax_runner(jax_pair):
    jr, tr = jax_pair['jr'], jax_pair['tr']
    assert tr.steps_per_epoch == jr.steps_per_epoch == 4
    jb, tb = jax_pair['batches']
    assert len(jb) == len(tb) == 4
    for i, (j, t) in enumerate(zip(jb, tb)):
        assert_same(t, j, f'batch {i}')
    assert jr.step == tr.step == 4


def test_first_log_record_matches_jax_runner(jax_pair):
    """Keys equal; lr equal in the JAX schedule's float32; every loss term,
    num_pos and grad_norm within rtol 1e-3 (the first interval: the first
    step and one after a warmup update)."""
    want = records(jax_pair['jr'].work_dir)[0]
    got = records(jax_pair['tr'].work_dir)[0]
    assert sorted(got) == sorted(want)
    assert (got['epoch'], got['iter']) == (want['epoch'], want['iter'])
    assert np.float32(got['lr']) == np.float32(want['lr'])
    for k in want:
        if k in ('mode', 'epoch', 'iter', 'lr', 'imgs_per_sec'):
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


# ----------------------------------------------------------------- the CLIs
def test_init_detector_serves_the_runner_model(runs):
    """init_detector(cfg, step) -> the trained model's detections, bit for
    bit, from the train-state checkpoint and from a published copy."""
    cfg, b2 = runs['cfg'], runs['b2']
    step = os.path.join(runs['work_b'], 'checkpoints', '8')
    img = np.random.RandomState(0).randint(0, 256, (120, 160, 3), np.uint8)
    want = Detector(cfg, b2.model.eval())(img)
    b2.model.train()
    out = publish_model.main([step, os.path.join(runs['d'], 'published')])
    for path in (step, out):
        got = init_detector(cfg, path, device='cpu')(img)
        for a, b in zip(got, want):
            assert_same(a, b, path)


def test_test_cli_checkpoint_serves_the_runner_model(runs, tmp_path,
                                                      capsys):
    """tools/test.py --checkpoint: the runner model's detections on every
    image (run_inference on the model in memory), bit for bit, and the
    runner's evaluation stats and copypaste numbers."""
    cfg, b2 = runs['cfg'], runs['b2']
    step = os.path.join(runs['work_b'], 'checkpoints', '8')
    out = ttest.main([runs['cfg_path'], '--checkpoint', step, '--device',
                      'cpu', '--json-out', str(tmp_path / 'res')])
    printed = capsys.readouterr().out
    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    loader = DataLoader(DeepFashion2Dataset(cfg.val_data, train=False),
                        cfg.val_data.batch_size, train=False)
    try:
        want = run_inference(b2.model.eval(), cfg, loader, verbose=False)
    finally:
        b2.model.train()
    assert sorted(out['results']) == sorted(want)
    for i in want:
        assert_same(out['results'][i], want[i], f'image {i}')
    assert out['stats'] == runs['stats']
    for iou_type, s in runs['stats'].items():
        line = ' '.join(f'{v:.4f}' for v in s.values())
        assert f'{iou_type}_mAP_copypaste: {line}' in printed


def test_train_cli_runs_without_jax_flax_cv2(runs, tmp_path):
    """tools/train.py in a process where jax, flax, cv2 and kgdet_tpu
    cannot be imported, reading PNGs: an epoch, its log, its checkpoint."""
    work = str(tmp_path / 'w')
    code = '\n'.join([
        'import sys',
        "for m in ('jax', 'flax', 'cv2', 'kgdet_tpu'):",
        '    sys.modules[m] = None',
        'import torch',
        'torch.set_num_threads(1)',
        'from kgdet_tpu_torch.tools.train import main',
        f"r = main([{runs['cfg_path']!r}, '--device', 'cpu', '--work-dir', "
        f"{work!r}, '--max-epochs', '1', '--log-interval', '2'])",
        "print('steps', r.step)",
        "print('ok', sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'cv2', 'kgdet_tpu') "
        "and sys.modules[k] is not None))",
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout.strip().splitlines()
    assert '[train] 8 images, 4 steps/epoch, device cpu' in out
    assert 'steps 4' in out and out[-1] == 'ok []'
    assert len(records(work)) == 2
    assert ckpt.CheckpointManager(os.path.join(work, 'checkpoints')) \
        .latest_step() == 4


def test_train_cli_initializes_from_a_checkpoint_or_pth(runs, tmp_path,
                                                         monkeypatch):
    """--load-from (a step of the port) and --load-pth (a reference-style
    .pth) give the runner those weights; --autoscale-lr scales by
    batch / 16."""
    monkeypatch.setattr(Runner, 'run', lambda self, **kw: None)
    step = os.path.join(runs['work_b'], 'checkpoints', '8')
    want = ckpt.load_params(step)
    pth = str(tmp_path / 'model.pth')
    torch.save({'state_dict': {f'module.{k}': v for k, v in want.items()}},
               pth)
    for flag, path in (('--load-from', step), ('--load-pth', pth)):
        r = ttrain.main([runs['cfg_path'], '--device', 'cpu', '--work-dir',
                         str(tmp_path / flag), flag, path,
                         '--autoscale-lr'])
        got = r.model.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (flag, k)
        assert r.cfg.optim.lr == pytest.approx(runs['cfg'].optim.lr * 2 / 16)
        assert r.step == 0


@pytest.mark.parametrize('task', ['cal_train_time', 'plot_curve'])
def test_analyze_logs_prints_what_the_jax_tool_prints(runs, task):
    log = os.path.join(runs['work_b'], 'train_log.jsonl')
    argv = [task, log, '--keys', 'loss', 'loss_cls_3', 'grad_norm', 'nokey']
    outs = []
    for main in (analyze_logs.main, janalyze.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if main is janalyze.main:
                old, sys.argv = sys.argv, ['analyze_logs'] + argv
                try:
                    main()
                finally:
                    sys.argv = old
            else:
                main(argv)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert ('epoch 2: imgs/s' if task == 'cal_train_time'
            else 'loss_cls_3: first') in outs[0]


def test_publish_model_drops_the_optimizer(runs, tmp_path):
    step = os.path.join(runs['work_b'], 'checkpoints', '8')
    out = publish_model.main([step, str(tmp_path)])
    state = torch.load(os.path.join(out, ckpt.FILE), weights_only=True)
    assert sorted(state) == ['model']
    tag = publish_model.content_tag(state['model'])
    assert out.endswith(f'kgdet_model-{tag}') and len(tag) == 8
    want = ckpt.load_params(step)
    assert sorted(state['model']) == sorted(want)
    assert all(torch.equal(state['model'][k], want[k]) for k in want)
    # the tag is the content's: one changed element changes it
    changed = dict(want)
    changed['bbox_head.moment_transfer'] = \
        changed['bbox_head.moment_transfer'] + 1
    assert publish_model.content_tag(changed) != tag


def test_several_devices_raise_naming_item_4(runs):
    with pytest.raises(NotImplementedError, match='item 4'):
        Runner(runs['cfg'], work_dir=runs['d'], n_devices=2, device='cpu')
    with pytest.raises(NotImplementedError, match='item 4'):
        ttrain.main([runs['cfg_path'], '--distributed', '--device', 'cpu'])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            Runner(runs['cfg'], work_dir=runs['d'])


def test_epoch_batches_follow_the_loader_seed(runs):
    """The batches a resumed epoch draws are those of grouped_batch_indices
    at (seed, epoch): what an uninterrupted run draws at that epoch."""
    b2 = runs['b2']
    b2.train_loader.set_epoch(1)
    want = grouped_batch_indices(b2.train_dataset.flags,
                                 runs['cfg'].train_data.batch_size, 1,
                                 runs['cfg'].seed)
    got = b2.train_loader._epoch_batches()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
