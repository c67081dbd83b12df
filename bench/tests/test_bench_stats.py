"""The tails' arithmetic on the harness's clock."""

import numpy as np

from bench import stats


def test_percentile_is_numpy_s_linear_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == np.percentile(v, 95) == 95.05
    assert stats.percentile([], 95) is None


def test_request_without_a_first_token_counts_to_the_window_end():
    done = stats.RequestClock(due=1.0)
    done.observe(1, 1.5)
    stalled = stats.RequestClock(due=2.0)
    assert done.ttft(10.0) == 0.5
    assert stalled.ttft(10.0) == 8.0
    # twenty requests, one stalled: the stall sets the tail
    clocks = [done] * 19 + [stalled]
    assert stats.ttft_p95_ms(clocks, 10.0) == \
        1e3 * np.percentile([0.5] * 19 + [8.0], 95)


def test_tokens_of_one_step_are_visible_together():
    c = stats.RequestClock(due=0.0)
    assert c.observe(2, 0.3) == 2       # first token and one decode token
    assert c.observe(2, 0.4) == 0
    assert c.observe(3, 0.5) == 1
    assert c.observe(5, 0.8) == 2
    assert c.first == 0.3
    np.testing.assert_allclose(c.gaps, [0.0, 0.2, 0.3, 0.0])
    assert stats.itl_p95_ms([c]) == 1e3 * np.percentile(c.gaps, 95)
