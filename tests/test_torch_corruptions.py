"""The port's corruptions and robustness CLI (kgdet_tpu_torch:
data/corruptions.py, tools/test_robustness.py) against kgdet_tpu: every
corruption at every severity bit for bit on one image under the same cv2,
and the CLI's table against the JAX CLI's on the same .pth and PNGs."""
import json
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip('cv2')

from kgdet_tpu.data import corruptions as jcorr
from kgdet_tpu_torch.data import corruptions as tcorr
from kgdet_tpu_torch.tools import test_robustness as trobust

torch.set_num_threads(1)


def test_every_corruption_and_severity_is_bit_equal():
    img = np.random.RandomState(0).randint(0, 256, (61, 83, 3), np.uint8)
    assert sorted(tcorr.CORRUPTIONS) == sorted(jcorr.CORRUPTIONS)
    for name in sorted(jcorr.CORRUPTIONS):
        for sev in range(1, 6):
            got = tcorr.corrupt(img, name, sev)
            want = jcorr.corrupt(img, name, sev)
            assert got.dtype == want.dtype == np.uint8, name
            np.testing.assert_array_equal(got, want, err_msg=f'{name} {sev}')
    with pytest.raises(ValueError, match='severity'):
        tcorr.corrupt(img, 'contrast', 6)
    with pytest.raises(KeyError, match='unknown corruption'):
        tcorr.corrupt(img, 'fog', 1)


def test_robustness_cli_matches_the_jax_cli(tmp_path, monkeypatch, capsys):
    """4 synthetic PNGs, one canvas, 2 corruptions x 1 severity, both CLIs
    on the same .pth: the detections each pass scores within the
    tolerances of tests/test_torch_eval.py (and changed by each
    corruption), the same table keys, every AP within 1e-3 (the tolerance
    of tests/test_torch_eval.py::test_cli_matches_jax_run_eval), the mean
    line printed."""
    from kgdet_tpu.api import build_model as jbuild_model
    from kgdet_tpu.api import init_variables
    from kgdet_tpu.config import load_config as jload_config
    from kgdet_tpu import eval_loop as jeval_loop
    from kgdet_tpu.tools import test_robustness as jrobust
    from kgdet_tpu_torch import eval_loop as teval_loop
    from kgdet_tpu_torch.utils.convert import state_dict_from_jax
    from tests.test_torch_eval import assert_dets_close, make_eval_set, \
        write_config
    from tests.test_torch_model import _perturb

    d = str(tmp_path)
    cfg_path = write_config(d, make_eval_set(d, n_images=4,
                                             landscape_only=True))
    jcfg = jload_config(cfg_path)
    variables = _perturb(init_variables(jbuild_model(jcfg), jcfg,
                                        canvas_hw=(64, 96)))
    pth = str(tmp_path / 'model.pth')
    torch.save({'state_dict': state_dict_from_jax(variables)}, pth)
    scored = {'port': [], 'jax': []}

    def recording(module, key):
        inner = module.evaluate_results

        def evaluate_results(results, *a, **kw):
            scored[key].append(results)
            return inner(results, *a, **kw)
        monkeypatch.setattr(module, 'evaluate_results', evaluate_results)
    recording(teval_loop, 'port')
    recording(jeval_loop, 'jax')
    args = [cfg_path, '--load-pth', pth, '--corruptions', 'gaussian_noise',
            'motion_blur', '--severities', '2']
    table, batches = trobust.main(args + ['--out', str(tmp_path / 't.json'),
                                          '--device', 'cpu'])
    printed = capsys.readouterr().out
    assert 'mean corruption bbox AP: ' in printed
    assert batches == 3                     # 4 images of batch 4, 3 passes
    monkeypatch.setattr(sys, 'argv', ['test_robustness'] + args
                        + ['--out', str(tmp_path / 'j.json')])
    jrobust.main()
    with open(tmp_path / 'j.json') as f:
        want = json.load(f)
    assert len(scored['port']) == len(scored['jax']) == 3
    for got, ref in zip(scored['port'], scored['jax']):
        assert_dets_close(got, ref, 'robustness pass')
    clean = scored['port'][0]
    for corrupted in scored['port'][1:]:
        assert any(not np.array_equal(corrupted[i][0], clean[i][0])
                   for i in clean)
    with open(tmp_path / 't.json') as f:
        assert json.load(f) == table
    assert list(table) == list(want) == [
        'clean', 'gaussian_noise/s2', 'motion_blur/s2']
    for k in want:
        assert list(table[k]) == ['bbox']
        np.testing.assert_allclose(table[k]['bbox'], want[k]['bbox'],
                                   atol=1e-3, err_msg=k)
