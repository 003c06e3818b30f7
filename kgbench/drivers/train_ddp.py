"""Data-parallel training: ``train_loop.py``'s set and loop with the
configuration's batch split over the cell's cards, one process a card, as
``runner.Runner.setup`` splits it (a batch of 8 over 4 processes: 2
images a process, each process's loader taking its stride of the epoch's
batches of 2, so the processes of one step may stand on different
canvases).

The driver writes the synthetic set once, then starts one process a card
(``spawn``); each joins the group through ``parallel/dist.py::
init_distributed`` (NCCL on the cards, gloo on the CPU), builds the
Runner with the benchmark's weights, and steps the Runner's own loop (its
loader, ``_device_prefetch`` and the train step of each canvas, which sums
the gradients over the processes) as ``train_loop.py`` does: the first
steps, which the reference follows, then until every process has stepped
every canvas ``warmup_steps_per_canvas`` times. The window runs whole
steps until ``seconds`` have passed on process 0, which tells the others
to stop one step later over a gloo group of its own (a broadcast waited
for a step after it is sent, so no process waits on it); a synchronize
ends it. ``train_img_s`` is the images of every process's steps in the
window over process 0's seconds; ``peak_mem_gib`` the largest process's.
Process 0's wait at each ``next()`` of its prefetch iterator is timed,
and with tracing the reference's operations an image are counted, as in
``train_loop.py``.
With tracing, process 0 runs ``train_loop.traced_steps``, then a stretch
under the profiler with the program's spans, from which the device time
of the NCCL kernels launched inside the ``allreduce`` span is read; the
other processes step alongside.

Then the processes are gone and the reference (on the driver's device)
derives each process's batches of the first steps from the same files and
records, and takes the same steps in float32 from the same weights, each
step's loss and gradients summed over the processes as the program sums
them (``kgbench/reference/train_shards.py``). ``correct`` is
``train_loop.py``'s: ``batch_gap``, ``loss_gap`` and ``update_gap`` under
the configuration's ``train_limits``.
"""
from __future__ import annotations

import itertools
import multiprocessing
import os
import shutil
import socket
import sys
import tempfile
import time

import numpy as np
import torch

from kgbench import check, serving, traffic, weights
from kgbench.drivers import train_loop

# the processes must have ended this long after the window should have
PROCESS_SLACK_S = 1500


def run(cell, seed, seconds, trace, t0, device):
    root = tempfile.mkdtemp(prefix='kgbench-ddp-')
    try:
        return _run(cell, seed, seconds, trace, t0, device, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def _start(cell, seed, seconds, trace, t0, device, root, paths):
    """The processes, one a rank, to their end; raises where one fails."""
    ctx = multiprocessing.get_context('spawn')
    port = _free_port()
    procs = [ctx.Process(target=worker, args=(
        cell, seed, seconds, trace, t0, rank, port, device.type, root,
        paths)) for rank in range(cell.chips)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + seconds + PROCESS_SLACK_S
    try:
        while any(p.exitcode is None for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed or time.perf_counter() > deadline:
                raise RuntimeError(f'train_ddp: process exit codes '
                                   f'{[p.exitcode for p in procs]}')
            time.sleep(0.2)
        if any(p.exitcode for p in procs):
            raise RuntimeError(f'train_ddp: process exit codes '
                               f'{[p.exitcode for p in procs]}')
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=False)
            for r in range(cell.chips)]


def _run(cell, seed, seconds, trace, t0, device, root):
    spec, mix = cell.config, cell.traffic
    paths = traffic.train_set(mix, seed, root)
    ann_file, folder, records, names = paths
    ranks = _start(cell, seed, seconds, trace, t0, device, root,
                   (ann_file, folder))
    r0, B = ranks[0], spec['train']['batch_size']
    n = r0['steps']
    if any(r['steps'] != n for r in ranks):
        raise RuntimeError(f'train_ddp: steps {[r["steps"] for r in ranks]}')
    peak = max(r['peak'] for r in ranks)
    ref = cell.module('reference', spec['reference'])
    w = weights.make(ref.param_specs(spec['model']), seed, device)
    checked = [[r['checked'][k] for r in ranks]
               for k in range(mix['checked_steps'])]
    readings = reference_readings(cell, w, records, names, folder, checked,
                                  r0['losses'], r0['first'], r0['after'],
                                  device)
    correct, rows = check.judge(readings, spec['train_limits'])
    for name in sorted(set(readings) - set(spec['train_limits'])):
        print(f'reading {name} {readings[name]!r} (not compared)',
              file=sys.stderr)
    obs = dict(r0['obs'], images=n * B, seconds=r0['seconds'], batch=B,
               model=spec['model'], canvases=spec['data']['canvases'])
    if trace:
        # the images of all the cards: a share of one card's peak is
        # this over the cards
        obs['flops_per_image'] = train_loop.train_flops_per_image(
            ref, w, spec, spec['data']['canvases'][0], device)
    return {'correct': correct, 'attempted': n * B, 'failed': 0,
            'e2e': {'train_img_s': n * B / r0['seconds'],
                    'peak_mem_gib': peak / 2 ** 30,
                    'setup_s': r0['setup_s']},
            'obs': obs, 'checks': rows, 'peak_bytes': peak}


def worker(cell, seed, seconds, trace, t0, rank, port, kind, root, paths):
    """One process of the group: its steps, saved to ``root``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(cell.chips), MASTER_ADDR='localhost',
                      MASTER_PORT=str(port))
    torch.set_num_threads(4)
    import torch.distributed as dist

    from kgdet_tpu_torch.parallel.dist import init_distributed
    device = init_distributed(torch.device('cuda', rank) if kind == 'cuda'
                              else torch.device('cpu'))
    try:
        out = _steps(cell, seed, seconds, trace, t0, rank, device, root,
                     *paths)
        torch.save(out, os.path.join(root, f'rank{rank}.pt'))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _feed(runner):
    """The Runner's prefetched batches, epoch after epoch."""
    while True:
        runner.train_loader.set_epoch(runner.epoch)
        yield from runner._device_prefetch(itertools.islice(
            runner.train_loader, runner.steps_per_epoch))
        runner.epoch += 1


def _steps(cell, seed, seconds, trace, t0, rank, device, root, ann_file,
           folder):
    import torch.distributed as dist

    from kgdet_tpu_torch.data.dataset import DeepFashion2Dataset
    from kgdet_tpu_torch.runner import Runner
    spec, mix = cell.config, cell.traffic
    ctl = dist.new_group(backend='gloo')
    cfg = train_loop.program_config(cell, ann_file, folder)
    ref = cell.module('reference', spec['reference'])
    w = weights.make(ref.param_specs(spec['model']), seed, device)
    runner = Runner(cfg, work_dir=os.path.join(root, f'work{rank}'),
                    device=device)
    runner.setup(init_state_dict=w,
                 train_dataset=DeepFashion2Dataset(cfg.train_data,
                                                   train=True))
    del w
    opt = runner.optimizer
    feed = _feed(runner)

    def step(it):
        """One step as Runner.train_epoch takes it, its logger's interval
        synchronize included: (batch, logs, wait at the feed)."""
        t = time.perf_counter()
        batch = next(feed)
        wait = time.perf_counter() - t
        logs = runner._get_step_fn(tuple(batch['image'].shape[1:3]))(batch)
        runner.step += 1
        lr = 0.0
        if (it + 1) % runner.logger.interval == 0:
            runner._sync()
            lr = float(runner.schedule(runner.step - 1))
        runner.logger.log_iter(runner.epoch, it, runner.steps_per_epoch,
                               logs, lr, 0.0)
        return batch, logs, wait

    out = {'checked': [], 'losses': []}
    seen, it = {}, 0
    need = mix['warmup_steps_per_canvas']
    canvases = [tuple(c) for c in spec['data']['canvases']]
    while True:
        batch, logs, _ = step(it)
        it += 1
        canvas = tuple(batch['image'].shape[1:3])
        seen[canvas] = seen.get(canvas, 0) + 1
        k = len(out['checked'])
        if k < mix['checked_steps']:
            out['checked'].append({n: v.detach().cpu().clone()
                                   for n, v in batch.items()})
            out['losses'].append(float(logs['loss']))
            if k == 0 and rank == 0:
                out['first'] = {n: m.detach().cpu().clone()
                                for n, m in zip(opt.names, opt.momentum)}
            if k + 1 == mix['checked_steps'] and rank == 0:
                out['after'] = {n: p.detach().cpu().clone()
                                for n, p in zip(opt.names, opt.params)}
            continue
        done = torch.tensor([min(seen.get(c, 0) for c in canvases) >= need],
                            dtype=torch.int32)
        dist.all_reduce(done, op=dist.ReduceOp.MIN, group=ctl)
        if done.item():
            break
    dist.barrier(group=ctl)
    serving.reset_peak(device)
    out['setup_s'] = time.perf_counter() - t0

    n, stop, pending, waits = 0, torch.zeros(1, dtype=torch.int32), None, []
    start = time.perf_counter()
    while True:
        waits.append(step(it)[2])
        it, n = it + 1, n + 1
        if pending is not None:
            pending.wait()
            if stop.item():
                break
        if rank == 0:
            stop[0] = int(time.perf_counter() - start >= seconds)
        pending = dist.broadcast(stop, 0, group=ctl, async_op=True)
    serving.sync(device)
    out['seconds'] = time.perf_counter() - start
    out['steps'] = n
    out['peak'] = serving.peak_bytes(device)
    out['obs'] = {'data_wait_s': waits}
    if trace:
        k = [it]

        def one():
            step(k[0])
            k[0] += 1
        calls = mix['traced_steps']
        if rank == 0:
            out['obs']['timeline'], out['obs']['stage_ms'] = \
                train_loop.traced_steps(runner.model, opt, one, calls)
            out['obs']['allreduce'] = allreduce_stretch(one, calls)
        else:
            for _ in range(3 * calls):
                one()
        serving.sync(device)
    return out


def allreduce_stretch(call, calls):
    """Runs ``call()`` ``calls`` times in a recording of the program's spans
    under the profiler: ``allreduce_reading`` of it; None without the
    program's tracer."""
    try:
        from kgdet_tpu_torch.utils import trace
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile
    serving.sync(torch.device('cuda'))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with trace.recording() as rec:
            for _ in range(calls):
                call()
            serving.sync(torch.device('cuda'))
    return allreduce_reading(rec.records, prof.events())


def allreduce_reading(records, events):
    """The ``allreduce`` span's calls among the records, and the device
    seconds of the NCCL kernels whose launch (the runtime call with the
    kernel's correlation id) lies inside one of its ``kgdet.allreduce``
    ranges."""
    from torch.autograd import DeviceType
    ranges = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CPU
              and e.name == 'kgdet.allreduce']
    launch = {e.id: e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith('cu')}
    inside = 0.0
    for e in events:
        call = launch.get(e.id)
        if e.device_type == DeviceType.CUDA and 'nccl' in e.name.lower() \
                and call is not None and any(
                    a <= call.time_range.start <= b for a, b in ranges):
            inside += (e.time_range.end - e.time_range.start) / 1e6
    return {'calls': sum(r.name == 'allreduce' for r in records),
            'device_s': inside}


def reference_batches(cell, records, names, folder, dtype=torch.float32):
    """Each process's batch of the first steps, derived again from the files
    and records: [step][process] -> batch."""
    import cv2

    from kgbench.reference import train_batch, train_shards
    spec, mix = cell.config, cell.traffic
    d, o = spec['data'], spec['train']
    wide = np.array([r['width'] / r['height'] > 1 for r in records])
    picks = train_shards.shard_picks(wide, cell.chips,
                                     o['batch_size'] // cell.chips,
                                     mix['checked_steps'], o['seed'])
    pixels = {}
    for idx in itertools.chain.from_iterable(picks):
        for i in idx:
            f = records[i]['file']
            if f not in pixels:
                pixels[f] = cv2.imread(os.path.join(folder, names[f]),
                                       cv2.IMREAD_COLOR)
    return [[train_batch.batch(
        records, pixels, idx,
        train_batch.flips(idx, 0, o['seed'], o['flip_ratio']),
        d['canvases'], d['img_scale'], o['max_gts'], dtype) for idx in step]
        for step in picks]


def reference_steps(ref, spec, w, steps, device, quant=None, keep=None):
    """The reference's first steps from weights ``w``, each on every
    process's batch, the loss and gradients summed over the processes as
    the program sums them: (losses, momentum after the first step,
    parameters after the last, first-step gradients). ``keep`` (a slice)
    takes only those processes into each step (a fault)."""
    from kgbench.reference import point_loss, train_batch, train_shards
    m = spec['model']
    free = train_loop.free_params(spec, w)
    params = {k: w[k].detach().clone() for k in free}
    momentum, losses, first, grads1 = {}, [], None, None
    for k, shards in enumerate(steps):
        if keep is not None:
            shards = shards[keep]
        feeds = [{n: torch.as_tensor(v).to(device) for n, v in b.items()}
                 for b in shards]
        canvases = [tuple(b['image'].shape[1:3]) for b in shards]
        counts = [train_shards.positive_count(f, m, c)
                  for f, c in zip(feeds, canvases)]
        total = sum(counts)
        live = {n: p.requires_grad_(True) for n, p in params.items()}
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        loss = 0.0
        for b, f, c, cnt in zip(shards, feeds, canvases, counts):
            x = serving.normalized(b['image'], b['valid_hw'], m['img_mean'],
                                   m['img_std']).to(device)
            outs = ref.forward(dict(w, **live), x, m, quant=quant)
            part = point_loss.loss(outs, f, m, c)[0] * (cnt / total)
            got = torch.autograd.grad(part, [live[n] for n in free],
                                      allow_unused=True)
            for n, g in zip(free, got):
                if g is not None:
                    grads[n] += g
            loss += float(part.detach())
            del outs, part, got
        for p in params.values():
            p.requires_grad_(False)
        train_batch.sgd_step(params, grads, momentum, k, spec['optim'])
        losses.append(loss)
        if k == 0:
            first = {n: v.clone() for n, v in momentum.items()}
            grads1 = grads
    return losses, first, params, grads1


def reference_readings(cell, w, records, names, folder, checked, losses,
                       first, after, device):
    """The numbers that decide ``correct``, from the first steps: the
    program's batches [step][process], its losses (summed over the
    processes), process 0's momentum after the first step and parameters
    after the last."""
    serving.exact_float32()
    spec = cell.config
    ref = cell.module('reference', spec['reference'])
    steps = reference_batches(cell, records, names, folder)
    readings = train_loop.side_gaps((losses, first, after), reference_steps(
        ref, spec, w, steps, device), w, device)
    readings['batch_gap'] = train_loop.batch_gap(
        list(itertools.chain.from_iterable(checked)),
        list(itertools.chain.from_iterable(steps)))
    return readings


def control_readings(cell, seed, device):
    """Against the float32 reference's first steps on the same set: the
    control (the reference's steps with every product in float8, and its
    batches derived in bfloat16) and the fault of process 0's images alone
    in each step."""
    spec, mix = cell.config, cell.traffic
    ref = cell.module('reference', spec['reference'])
    serving.exact_float32()
    root = tempfile.mkdtemp(prefix='kgbench-ddp-')
    try:
        _, folder, records, names = traffic.train_set(mix, seed, root)
        w = weights.make(ref.param_specs(spec['model']), seed, device)
        steps = reference_batches(cell, records, names, folder)
        low = reference_batches(cell, records, names, folder,
                                torch.bfloat16)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    exact = reference_steps(ref, spec, w, steps, device)
    control = train_loop.side_gaps(
        reference_steps(ref, spec, w, steps, device, quant=ref.fp8), exact,
        w, device)
    control['batch_gap'] = train_loop.batch_gap(
        list(itertools.chain.from_iterable(low)),
        list(itertools.chain.from_iterable(steps)))
    one = train_loop.side_gaps(reference_steps(
        ref, spec, w, steps, device, keep=slice(0, 1)), exact, w, device)
    return {'control': control, 'one_process': one}
