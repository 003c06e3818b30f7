"""Checkpoints of the port: train states and model weights as torch.save
files, with retention and resume.

The port's counterpart of kgdet_tpu/utils/checkpoint.py (Orbax there), with
the same interface: ``CheckpointManager(directory, max_to_keep)`` with
``save(step, state)``, ``restore(step)``, ``latest_step()`` and ``close()``,
and ``save_params`` / ``load_params``. A step lives in
``<directory>/<step>/checkpoint.pt``, so that a path such as
``work_dirs/x/checkpoints/16`` names a step as it does in the JAX package.
Neither package reads the other's files.

A checkpoint holds tensors, ints, floats, strings, lists and dicts only, so
that it loads with ``torch.load(weights_only=True)``; every tensor is saved
on the CPU and loads onto the CPU, wherever it was written. Saves are
synchronous (the JAX package's are asynchronous): each file is written under
a temporary name and moved into place with ``os.replace``, so a run killed
during a save leaves the previous step as ``latest_step()``, which counts a
step only once its file is complete.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

FILE = 'checkpoint.pt'


def _abspath(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def to_cpu(state):
    """``state`` with every tensor detached and copied to the CPU (a new
    storage each, so that no tensor saves a larger storage it views)."""
    if torch.is_tensor(state):
        return state.detach().to('cpu', copy=True)
    if isinstance(state, dict):
        return {k: to_cpu(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [to_cpu(v) for v in state]
    return state


def _write(path: str, state: Dict[str, Any]):
    """torch.save to a temporary name beside ``path``, then os.replace."""
    tmp = f'{path}.tmp-{os.getpid()}'
    try:
        torch.save(to_cpu(state), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _read(path: str):
    return torch.load(path, map_location='cpu', weights_only=True)


class CheckpointManager:
    """Train-state dicts by step under ``directory``; ``max_to_keep`` keeps
    the newest steps and deletes the rest after each save."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = _abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> List[int]:
        """The complete steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, FILE)))

    def save(self, step: int, state: Dict[str, Any], wait: bool = False):
        """Write ``state`` as step ``step``. ``wait`` is accepted for the
        JAX package's interface; the save is always complete on return."""
        del wait
        d = self._step_dir(step)
        os.makedirs(d, exist_ok=True)
        _write(os.path.join(d, FILE), state)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old))

    def restore(self, step: int) -> Dict[str, Any]:
        return _read(os.path.join(self._step_dir(step), FILE))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self):
        """Nothing is in flight: saves are synchronous."""


def save_params(path: str, state_dict: Dict[str, Any]):
    """One-shot save of a model's weights: ``path`` becomes a directory
    holding checkpoint.pt with ``{'model': state_dict}``."""
    path = _abspath(path)
    os.makedirs(path, exist_ok=True)
    _write(os.path.join(path, FILE), {'model': dict(state_dict)})


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """The model state_dict of a checkpoint of the port, on the CPU:
    ``path`` is a step of a CheckpointManager (a train state), a directory
    written by save_params, or the checkpoint.pt file of either."""
    path = _abspath(path)
    if os.path.isdir(path):
        path = os.path.join(path, FILE)
    state = _read(path)
    if 'model' not in state:
        raise KeyError(f'{path} holds no model state_dict (keys '
                       f'{sorted(state)})')
    return state['model']
