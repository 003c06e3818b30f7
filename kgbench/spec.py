"""Finds what belongs to a cell by the names in ``BENCHMARK.json``: its
configuration file, its traffic mix (``kgbench/traffic/<traffic>.json``),
the driver the mix names (``kgbench/drivers/<driver>.py``), the reference
and decode the configuration names (``kgbench/reference/<name>.py``), and
the reader of each per-layer metric it reports
(``kgbench/metrics/<metric>.py``). Adding a cell, a mix, a configuration
or a metric is adding files and entries."""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass
class Cell:
    root: str
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def module(self, kind, name):
        """``kgbench.<kind>.<name>``: a driver or a reference."""
        return importlib.import_module(f'kgbench.{kind}.{name}')


def _json(path):
    with open(path) as f:
        return json.load(f)


def reports(metric, cell_name, reported=None):
    """Whether a cell reports a metric: the cells its ``workloads`` lists,
    or, without the key, every cell (an end-to-end metric) or every cell
    that reports the end-to-end metric it ``moves``."""
    if 'workloads' in metric:
        return cell_name in metric['workloads']
    return reported is None or metric['moves'] in reported


def load(root, workload):
    bench = _json(os.path.join(root, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
    w = cells[workload]
    conf = next(c for c in bench['configs'] if c['name'] == w['config'])
    e2e = [m for m in bench['end_to_end'] if reports(m, workload)]
    names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if reports(m, workload, names)]
    return Cell(root=root, name=workload, chips=w['chips'],
                config=_json(os.path.join(root, conf['file'])),
                traffic=_json(os.path.join(HERE, 'traffic',
                                           f'{w["traffic"]}.json')),
                end_to_end=e2e, per_layer=per_layer)


def reader(metric_name):
    """The ``read(observations)`` function of a per-layer metric."""
    path = os.path.join(HERE, 'metrics', f'{metric_name}.py')
    spec = importlib.util.spec_from_file_location(
        f'kgbench_metric_{metric_name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
