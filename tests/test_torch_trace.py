"""The program's spans (kgdet_tpu_torch/utils/trace.py) on the CPU: nothing
recorded, no clock read and no profiler range entered without a
recording; inside one, the span tree of a predict call, a train step, a
``Detector`` call and the Runner's device prefetch on the tiny R-50 model
of tests/test_torch_model.py, of a two-stage and an HTC predict call, and
no ``allreduce`` in a step outside a process group (a two-process step's
is in tests/test_torch_dist.py); threads apart; and the profiler's
``kgdet.<name>`` ranges on the records' clock shifted by ``anchor_ns``.
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kgdet_tpu_torch.api import Detector, init_trainer, make_predict_fn
from kgdet_tpu_torch.runner import Runner
from kgdet_tpu_torch.utils import trace
from tests.common import synth_batch
from tests.test_torch_model import CANVAS, tiny_r50_cfg

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def trainer():
    cfg = tiny_r50_cfg()
    model, opt, step = init_trainer(cfg, CANVAS, steps_per_epoch=10,
                                    device='cpu')
    return cfg, model.eval(), step


def _batch():
    rng = np.random.RandomState(0)
    return {'image': rng.randint(0, 256, (1,) + CANVAS + (3,), np.uint8),
            'img_hw': np.asarray([[60, 90]], np.float32),
            'scale_factor': np.ones(1, np.float32)}


def _tree(records):
    """{name: record} of spans that each appear once, and the root ids."""
    by_name = {r.name: r for r in records}
    assert len(by_name) == len(records), [r.name for r in records]
    return by_name, {r.root for r in records}


def _inside(child, parent):
    assert child.parent == parent.id and child.root == parent.root
    assert parent.start_ns <= child.start_ns <= child.end_ns \
        <= parent.end_ns, (child.name, parent.name)


def test_off_path_is_one_shared_no_op_that_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError('a span read the clock with no recording')
    monkeypatch.setattr(trace.time, 'perf_counter_ns', no_clock)
    assert trace.span('predict') is trace.span('step')
    with trace.span('predict') as s:
        with trace.span('forward'):
            pass
    assert s is trace.span('decode')
    monkeypatch.undo()
    with trace.recording() as rec:
        pass
    assert rec.records == [] and trace.span('predict') is s


def test_no_kgdet_range_under_the_profiler_without_a_recording(trainer):
    cfg, model, _ = trainer
    predict = make_predict_fn(model, cfg, CANVAS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predict(_batch())
    names = {e.name for e in prof.events()}
    assert 'aten::conv2d' in names
    assert not [n for n in names if n.startswith('kgdet.')]


def test_predict_spans_nest_under_one_root(trainer):
    cfg, model, _ = trainer
    predict = make_predict_fn(model, cfg, CANVAS)
    with trace.recording() as rec:
        predict(_batch())
    s, roots = _tree(rec.records)
    assert set(s) == {'predict', 'forward', 'backbone', 'neck', 'head',
                      'decode'}
    assert roots == {s['predict'].id} and s['predict'].parent is None
    for child, parent in (('forward', 'predict'), ('backbone', 'forward'),
                          ('neck', 'forward'), ('head', 'forward'),
                          ('decode', 'predict')):
        _inside(s[child], s[parent])
    assert s['backbone'].end_ns <= s['neck'].start_ns
    assert s['neck'].end_ns <= s['head'].start_ns
    assert s['forward'].end_ns <= s['decode'].start_ns


def _tiny_faster_rcnn(detector_type='faster_rcnn', **extra):
    from kgdet_tpu_torch.api import build_model
    from kgdet_tpu_torch.config import (
        BackboneConfig, HeadConfig, KGDetConfig, NeckConfig, TestConfig)
    cfg = KGDetConfig(
        detector_type=detector_type, backbone=BackboneConfig(depth=18),
        neck=NeckConfig(in_channels=(64, 128, 256, 512), out_channels=64,
                        start_level=1, num_outs=3, add_extra_convs=False,
                        select_out=None, norm=None),
        head=HeadConfig(num_classes=13, point_strides=(8, 16, 32),
                        anchor_ratios=(0.5, 1.0, 2.0), num_stuff_classes=7),
        test=TestConfig(nms_pre=50, max_per_class=10, max_per_img=20),
        num_proposals_train=64, num_proposals_test=64,
        compute_dtype='float32', **extra)
    return cfg, build_model(cfg, device='cpu').init_weights(0).eval()


TWO_STAGE_FORWARD = ('backbone', 'neck', 'rpn', 'proposals', 'roi_extract',
                     'roi_head')


def test_two_stage_predict_spans_nest_under_the_forward(monkeypatch):
    cfg, model = _tiny_faster_rcnn()
    predict = make_predict_fn(model, cfg, CANVAS)
    predict(_batch())               # anchors cached; nothing recorded
    with trace.recording() as rec:
        predict(_batch())
    s, roots = _tree(rec.records)
    assert set(s) == {'predict', 'forward', 'decode', *TWO_STAGE_FORWARD}
    assert roots == {s['predict'].id} and s['predict'].parent is None
    _inside(s['forward'], s['predict'])
    _inside(s['decode'], s['predict'])
    for child in TWO_STAGE_FORWARD:
        _inside(s[child], s['forward'])
    order = [s[n] for n in TWO_STAGE_FORWARD]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))
    assert s['forward'].end_ns <= s['decode'].start_ns

    def no_clock():
        raise AssertionError('a span read the clock with no recording')
    monkeypatch.setattr(trace.time, 'perf_counter_ns', no_clock)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predict(_batch())
    assert not [e.name for e in prof.events()
                if e.name.startswith('kgdet.')]


def test_htc_forward_records_the_semantic_and_mask_head_spans_once():
    cfg, model = _tiny_faster_rcnn('htc', with_semantic=True)
    predict = make_predict_fn(model, cfg, CANVAS)
    predict(_batch())               # anchors cached; nothing recorded
    with trace.recording() as rec:
        predict(_batch())
    names = [r.name for r in rec.records]
    assert names.count('semantic') == 1 and names.count('mask_head') == 1
    assert names.count('roi_head') == 3 and names.count('roi_extract') == 4
    s = {r.name: r for r in rec.records
         if r.name in ('forward', 'semantic', 'mask_head', 'decode')}
    _inside(s['semantic'], s['forward'])
    _inside(s['mask_head'], s['forward'])
    assert s['semantic'].end_ns <= s['mask_head'].start_ns
    assert s['forward'].end_ns <= s['decode'].start_ns


def test_train_step_spans_nest_under_one_root(trainer):
    cfg, _, step = trainer
    batch = synth_batch(canvas=CANVAS, B=1, G=2, K=cfg.head.num_keypts)
    with trace.recording() as rec:
        step(batch)
    s, roots = _tree(rec.records)
    assert set(s) == {'step', 'forward', 'backbone', 'neck', 'head', 'loss',
                      'backward', 'optimizer'}
    assert roots == {s['step'].id}
    for child in ('forward', 'loss', 'backward', 'optimizer'):
        _inside(s[child], s['step'])
    order = [s[n] for n in ('forward', 'loss', 'backward', 'optimizer')]
    assert all(a.end_ns <= b.start_ns for a, b in zip(order, order[1:]))


def test_train_step_at_world_one_records_no_allreduce(trainer):
    from kgdet_tpu_torch.parallel.dist import all_reduce_grads
    cfg, _, step = trainer
    batch = synth_batch(canvas=CANVAS, B=1, G=2, K=cfg.head.num_keypts)
    before = all_reduce_grads.bytes
    with trace.recording() as rec:
        step(batch)
    names = [r.name for r in rec.records]
    assert 'step' in names and 'allreduce' not in names
    assert all_reduce_grads.bytes == before


def test_detector_call_spans_nest_under_the_request(trainer):
    cfg, model, _ = trainer
    img = np.random.RandomState(1).randint(0, 256, (50, 70, 3), np.uint8)
    detector = Detector(cfg, model)
    with trace.recording() as rec:
        detector(img)
    s, roots = _tree(rec.records)
    assert {'request', 'preprocess', 'predict', 'forward', 'decode',
            'fetch'} <= set(s)
    assert roots == {s['request'].id}
    for child in ('preprocess', 'predict', 'fetch'):
        _inside(s[child], s['request'])
    assert s['preprocess'].end_ns <= s['predict'].start_ns
    assert s['predict'].end_ns <= s['fetch'].start_ns


def test_device_prefetch_spans_each_fetch_and_stage(tmp_path):
    runner = Runner(tiny_r50_cfg(), work_dir=str(tmp_path), device='cpu')
    host = [{'image': np.full((1, 4, 4, 3), i, np.uint8)} for i in range(2)]
    with trace.recording() as rec:
        out = list(runner._device_prefetch(iter(host)))
    assert [int(b['image'][0, 0, 0, 0]) for b in out] == [0, 1]
    names = [r.name for r in rec.records]
    assert names.count('data.fetch') == 2 and names.count('data.stage') == 2
    assert all(r.parent is None for r in rec.records)


def test_threads_keep_their_own_parents():
    go = threading.Barrier(2, timeout=30)

    def work(name):
        with trace.span(name):
            go.wait()               # both outer spans open at once
            with trace.span(name + '.inner'):
                go.wait()
    with trace.recording() as rec:
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ('a', 'b')]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    s, roots = _tree(rec.records)
    assert len(roots) == 2
    _inside(s['a.inner'], s['a'])
    _inside(s['b.inner'], s['b'])
    assert s['a'].thread != s['b'].thread


def test_one_recording_at_a_time_and_failed_spans_record_nothing():
    with trace.recording() as rec:
        with pytest.raises(RuntimeError, match='already open'):
            with trace.recording():
                pass
        with pytest.raises(ValueError):
            with trace.span('step'):
                with trace.span('loss'):
                    pass
                raise ValueError
    assert [r.name for r in rec.records] == ['loss']
    with trace.recording() as again:    # the first one closed
        with trace.span('step'):
            pass
    assert [r.name for r in again.records] == ['step']


def test_profiler_ranges_lie_on_the_records_clock(trainer):
    cfg, model, _ = trainer
    predict = make_predict_fn(model, cfg, CANVAS)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            trace.recording() as rec:
        predict(_batch())
        predict(_batch())
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events() if e.name.startswith('kgdet.')),
                    key=lambda x: (x[0], -x[1]))
    records = sorted(rec.records, key=lambda r: r.start_ns)
    assert [n for _, _, n in ranges] == [f'kgdet.{r.name}' for r in records]
    # 2 ms: a loaded host (six test workers) delays a mark, never its clock
    for (start, end, _), r in zip(ranges, records):
        assert abs(t0 + start * 1e3 - (r.start_ns + rec.anchor_ns)) < 2e6
        assert abs(t0 + end * 1e3 - (r.end_ns + rec.anchor_ns)) < 2e6
