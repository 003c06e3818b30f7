"""The benchmark's own tests (``python -m pytest kgbench/tests``): on the
CPU at small sizes; those marked ``gpu`` need a CUDA card and skip, in a
fixture, without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'gpu: needs a CUDA card; skips, in its fixture, without '
        'one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA card')
    return torch.device('cuda', 0)
