"""The generator makes a cell's inputs from the seed alone, and every
seed gets the same sizes and arrival gaps in an order of its own."""
import numpy as np

from kgbench import traffic
from kgbench.tests import tiny

BIG = 2 ** 31 + 12345


def test_offline_batches_deterministic_and_same_work_every_seed():
    mix, data = tiny.offline_mix(), tiny.config()['data']
    a, order_a = traffic.offline_batches(mix, data, BIG)
    b, order_b = traffic.offline_batches(mix, data, BIG)
    c, _ = traffic.offline_batches(mix, data, BIG + 1)
    assert order_a == order_b
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not all(np.array_equal(x['image'], y['image'])
                   for x, y in zip(a, c))
    assert sorted(tuple(hw) for x in a for hw in x['img_hw'].tolist()) == \
        sorted(tuple(hw) for x in c for hw in x['img_hw'].tolist())
    assert sorted(x['image'].shape for x in a) == \
        sorted(x['image'].shape for x in c)


def test_open_loop_deterministic_same_gaps_every_seed():
    mix = tiny.online_mix()
    imgs, due, which = traffic.open_loop(mix, BIG, 10.0)
    imgs2, due2, which2 = traffic.open_loop(mix, BIG, 10.0)
    _, due3, which3 = traffic.open_loop(mix, BIG + 7, 10.0)
    np.testing.assert_array_equal(due, due2)
    np.testing.assert_array_equal(which, which2)
    for x, y in zip(imgs, imgs2):
        np.testing.assert_array_equal(x, y)
    assert len(due) == round(mix['rate_per_s'] * 10.0)
    assert due[0] >= 0 and due[-1] < 10.0 and np.all(np.diff(due) >= 0)
    assert not np.array_equal(due, due3)
    gaps = np.sort(np.diff(np.concatenate([[0.0], due, [10.0]])))
    gaps3 = np.sort(np.diff(np.concatenate([[0.0], due3, [10.0]])))
    np.testing.assert_allclose(gaps, gaps3, rtol=1e-9, atol=1e-12)
    assert sorted(np.bincount(which)) == sorted(np.bincount(which3))


def test_sample_holds_its_always_member():
    got = traffic.sample(BIG, range(50), 5, always=[49])
    assert 49 in got and len(got) == 5
    assert got == traffic.sample(BIG, range(50), 5, always=[49])
