"""The rate sweep that fixes an open-loop mix's rate: the cell run at each
rate given, one process, with the backlog's trend beside the latencies.

    python3 kgbench/sweep.py --workload <cell> --seconds 20 \
        --seed <n> --rates 6 7 8 9

A rate is sustained when the requests of the window's last quarter wait
no longer than those of its first. One JSON line a rate. The benchmark's
own runs do not run this.
"""
import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

sys.path[0] = os.getcwd()          # the checkout's root


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, default=20.0)
    p.add_argument('--seed', type=int, default=1)
    p.add_argument('--rates', type=float, nargs='+', required=True)
    args = p.parse_args()
    import torch

    from kgbench import spec
    base = spec.load(os.getcwd(), args.workload)
    driver = base.module('drivers', base.traffic['driver'])
    for rate in args.rates:
        cell = dataclasses.replace(base, traffic=dict(base.traffic,
                                                      rate_per_s=rate))
        res = driver.run(cell, args.seed, args.seconds, False,
                         time.perf_counter(), torch.device('cuda', 0))
        obs = res['obs']
        wait, lat = obs['wait_s'], obs['latency_s']
        q = max(1, len(wait) // 4)
        print(json.dumps({
            'rate_per_s': rate, 'requests': obs['requests'],
            'p50_ms': 1e3 * statistics.median(lat),
            'p95_ms': res['e2e']['serve_p95_ms'],
            'service_median_ms': 1e3 * statistics.median(obs['service_s']),
            'wait_first_quarter_ms': 1e3 * statistics.mean(wait[:q]),
            'wait_last_quarter_ms': 1e3 * statistics.mean(wait[-q:]),
            'correct': res['correct']}), flush=True)


if __name__ == '__main__':
    main()
