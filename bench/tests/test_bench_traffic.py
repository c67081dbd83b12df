"""The traffic generator: one seed, one trace; every seed the same sizes
and gaps in another order."""

import numpy as np
import pytest

from bench import traffic

OPEN = {"loop": "open", "arrival": {"kind": "poisson", "rate": 8.0},
        "prompt": {"dist": "lognormal", "median": 256, "sigma": 1.0,
                   "min": 32, "max": 1024},
        "output": {"dist": "lognormal", "median": 128, "sigma": 1.0,
                   "min": 16, "max": 512}}
BURST = dict(OPEN, arrival={"kind": "burst", "size": 16, "rate": 8.0})
CLOSED = {"loop": "closed", "clients": 32,
          "prompt": {"dist": "lognormal", "median": 2048, "sigma": 1.0,
                     "min": 512, "max": 4032},
          "output": {"dist": "uniform", "min": 16, "max": 64}}


@pytest.mark.parametrize("wl", [OPEN, BURST], ids=["poisson", "burst"])
def test_open_schedule_is_the_seed_s(wl):
    a = traffic.open_schedule(wl, 2 ** 31 + 11, 30.0)
    b = traffic.open_schedule(wl, 2 ** 31 + 11, 30.0)
    c = traffic.open_schedule(wl, 2 ** 31 + 12, 30.0)
    assert a == b
    assert a != c
    # the same work for every seed: sizes and gaps, in another order
    for key in ("prompt_len", "max_new"):
        assert sorted(getattr(e, key) for e in a) == \
            sorted(getattr(e, key) for e in c)
    assert len(a) == 240
    assert all(0.0 <= e.due < 30.0 for e in a)
    assert a[0].due == 0.0
    assert [e.due for e in a] == sorted(e.due for e in a)


def test_bursts_fall_due_together_at_a_fixed_spacing():
    s = traffic.open_schedule(BURST, 5, 30.0)
    for i in range(0, len(s), 16):
        assert len({e.due for e in s[i:i + 16]}) == 1
    assert sorted({e.due for e in s}) == [2.0 * k for k in range(15)]


@pytest.mark.parametrize("seconds", [30.0, 31.9, 51.0])
def test_every_burst_has_its_whole_period_in_the_window(seconds):
    s = traffic.open_schedule(BURST, 5, seconds)
    period = 16 / 8.0
    assert len(s) == 16 * int(seconds // period)
    assert max(e.due for e in s) + period <= seconds


def test_every_burst_holds_the_same_lengths_in_its_own_order():
    s = traffic.open_schedule(BURST, 2 ** 31 + 5, 30.0)
    want = {key: sorted(traffic.quantiles(BURST[name], 16)) for key, name
            in (("prompt_len", "prompt"), ("max_new", "output"))}
    orders = set()
    for i in range(0, len(s), 16):
        burst = s[i:i + 16]
        for key in want:
            assert sorted(getattr(e, key) for e in burst) == want[key]
        orders.add(tuple(e.prompt_len for e in burst))
    assert len(orders) > 1


def test_closed_pool_cycles_through_one_stratified_set():
    pool = traffic.ClosedPool(CLOSED, 9)
    again = traffic.ClosedPool(CLOSED, 9)
    first = [pool.entry(k) for k in range(64)]
    assert first == [again.entry(k) for k in range(64)]
    cyc0 = sorted(e.prompt_len for e in first[:32])
    cyc1 = sorted(e.prompt_len for e in first[32:])
    assert cyc0 == cyc1 == list(traffic.quantiles(CLOSED["prompt"], 32))
    assert [e.prompt_len for e in first[:32]] != \
        [e.prompt_len for e in first[32:]]


def test_quantiles_follow_the_distribution():
    q = traffic.quantiles({"dist": "lognormal", "median": 256, "sigma": 1.0,
                           "min": 1, "max": 10 ** 9}, 1001)
    assert q[500] == 256
    assert abs(np.log(q[841] / 256) - 1.0) < 0.01      # one sigma up
    u = traffic.quantiles({"dist": "uniform", "min": 16, "max": 64}, 49)
    assert list(u) == list(range(16, 65))


def test_prompt_tokens_are_the_seed_s():
    a = traffic.prompt_tokens(7, 3, 100, 50304)
    assert a.shape == (1, 100) and a.dtype == np.int32
    assert np.array_equal(a, traffic.prompt_tokens(7, 3, 100, 50304))
    assert not np.array_equal(a, traffic.prompt_tokens(7, 4, 100, 50304))
    assert a.min() >= 0 and a.max() < 50304
