"""On the card: every cell of BENCHMARK.json runs a short window through
the command's own entry and prints a correct result line naming the card.
Skips, in its fixture, without a CUDA card."""
import json
import os

import pytest

from kgbench import run
from kgbench.tests.tiny import ROOT

CELLS = [w['name'] for w in json.load(open(os.path.join(
    ROOT, 'BENCHMARK.json')))['workloads']]


@pytest.mark.gpu
@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_correct_on_the_card(cell, card, capsys, monkeypatch):
    import torch
    monkeypatch.chdir(ROOT)
    rc = run.main(['--workload', cell, '--seed', str(2 ** 31 + 17),
                   '--seconds', '3', '--trace', '0'])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert line['correct'], line['checks']
    assert line['device']['kind'] == torch.cuda.get_device_name(card)
    assert line['device']['memory_peak_bytes'] > 0
    assert 'setup_s' in line['metrics']
