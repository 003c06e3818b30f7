"""Readings that the limits of ``correct`` are set from (PERF.md gives
them): the program's, from short runs of a cell on many seeds in one
process, and the control's and the planted faults' (each driver's
``control_readings``: the reference put in the program's place in a lower
precision, or broken), on the same inputs as a run, at the cell's own
sizes.

    python3 kgbench/calibrate.py --workload <cell> --seconds 3 \
        --seeds <n> ... --control-seeds <n> ...

One JSON line a seed. The benchmark's own runs do not run this.
"""
import argparse
import json
import os
import sys
import time

sys.path[0] = os.getcwd()          # the checkout's root


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, default=3.0)
    p.add_argument('--seeds', type=int, nargs='*', default=[])
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    args = p.parse_args()
    import torch

    from kgbench import spec
    cell = spec.load(os.getcwd(), args.workload)
    device = torch.device('cuda', 0)
    driver = cell.module('drivers', cell.traffic['driver'])
    for seed in args.seeds:
        res = driver.run(cell, seed, args.seconds, False, time.perf_counter(),
                         device)
        print(json.dumps({'seed': seed, 'side': 'program',
                          'readings': {n: v for n, v, _ in res['checks']},
                          'e2e': res['e2e']}), flush=True)
    for seed in args.control_seeds:
        print(json.dumps({'seed': seed, 'side': 'control',
                          'readings': driver.control_readings(cell, seed,
                                                              device)}),
              flush=True)


if __name__ == '__main__':
    main()
