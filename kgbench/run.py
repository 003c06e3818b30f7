"""Runs one cell of the benchmark once and prints its result line.

    python3 kgbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program (``kgdet_tpu_torch``)
and the configuration files it loads. The run loads, warms up every shape
of the cell, measures for ``--seconds``, checks what the timed path
produced against the plain reference, and prints one JSON object as the
last line of standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read from a traced
stretch at the end of the window. It prints no result, and exits with
another code than 0, without the CUDA cards the cell asks for, or when
JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'kgdet_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({n for n in sys.modules if n.split('.')[0] in FORBIDDEN})


def power_limit():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace('\n', '; ')
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi: {e}'


def result_line(cell, res, trace):
    """The contract's result: correct, attempted, failed, metrics, device,
    with --trace 1 a breakdown, and the numbers compared, last."""
    import torch

    from kgbench import spec, timeline
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m['name'])(res['obs'])
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        metrics = {m['name']: {'value': res['e2e'][m['name']],
                               'unit': m['unit']} for m in cell.end_to_end}
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': cell.chips, 'memory_peak_bytes': res['peak_bytes']}
    line = {'correct': res['correct'], 'attempted': res['attempted'],
            'failed': res['failed'], 'metrics': metrics, 'device': device}
    if trace:
        tl = res['obs']['timeline']
        device['busy_s'] = tl['busy_s']
        device['window_s'] = tl['window_s']
        line['breakdown'] = timeline.breakdown(tl)
    line['checks'] = {name: {'value': v, 'limit': lim}
                      for name, v, lim in res['checks']}
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.getcwd()
    # the program's kernel caches at fixed paths inside the checkout
    cache = os.path.join(root, '.kgbench_cache')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['CUDA_CACHE_PATH'] = os.path.join(cache, 'nv')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ['USE_FLAX'] = '0'

    from kgbench import spec
    cell = spec.load(root, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'kgbench: {args.workload} needs {cell.chips} CUDA card(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    driver = cell.module('drivers', cell.traffic['driver'])
    res = driver.run(cell, args.seed, args.seconds, bool(args.trace), T0,
                     torch.device('cuda', 0))
    found = forbidden_modules()
    if found:
        print(f'kgbench: JAX or the JAX package was loaded: {found}',
              file=sys.stderr)
        return 4
    line = result_line(cell, res, bool(args.trace))
    print(f'card: {power_limit()}', file=sys.stderr)
    for name, v, lim in res['checks']:
        print(f'check {name} {v!r} limit {lim!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.path[0] = os.getcwd()       # the checkout's root, not kgbench/
    sys.exit(main())
