"""The system under test, as the benchmark reaches it: the repository's
configuration file loaded by the program's own loader, with the cell's
stated changes, held to the sizes the benchmark's configuration file
states, and the program's model built on the device with the benchmark's
weights."""
from __future__ import annotations

import dataclasses
import os


def _replace(obj, dotted, value):
    head, _, rest = dotted.partition('.')
    if not rest:
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(
        obj, **{head: _replace(getattr(obj, head), rest, value)})


def _get(obj, dotted):
    for part in dotted.split('.'):
        obj = getattr(obj, part)
    return obj


def _plain(v):
    """Tuples as lists, for comparison with JSON."""
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    return v


def load_config(root, spec):
    """The program's config for a configuration file of the benchmark:
    ``repo_config`` through ``kgdet_tpu_torch.config.load_config``, then
    ``overrides`` (dotted field -> value). Raises if any field under
    ``holds`` (dotted field -> value) reads otherwise, so that the file
    states the configuration as it is run."""
    from kgdet_tpu_torch.config import load_config as program_load
    cfg = program_load(os.path.join(root, spec['repo_config']))
    for key, value in spec.get('overrides', {}).items():
        cfg = _replace(cfg, key, value)
    wrong = {k: (_plain(_get(cfg, k)), v) for k, v in spec['holds'].items()
             if _plain(_get(cfg, k)) != v}
    if wrong:
        raise ValueError(f'{spec["repo_config"]} departs from the '
                         f'benchmark\'s configuration: {wrong}')
    return cfg


def build(cfg, weights, device):
    """The program's model on ``device`` with ``weights`` (strict: the
    program holds exactly the parameters the reference names), in eval
    mode."""
    import torch

    from kgdet_tpu_torch.api import build_model
    with torch.device(device):
        model = build_model(cfg, device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()
