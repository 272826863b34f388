"""The end-to-end arithmetic: percentiles over all requests, unfinished
requests counted as failed, rates over the whole window."""

import numpy as np
import pytest

from portbench.harness import stats
from portbench.harness.stats import Served


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys_linear(q):
    xs = list(np.random.default_rng(q).exponential(size=201))
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_unfinished_request_is_failed_and_counts_to_the_end():
    reqs = [Served("a", 1.0, first=1.5, finish=3.0, tokens=4),
            Served("b", 2.0, first=None, finish=None),
            Served("c", 2.0, first=2.2, finish=None, tokens=0)]
    assert stats.failed(reqs) == 2
    assert stats.ttft_values(reqs, end=10.0) == pytest.approx([0.5, 8.0,
                                                               0.2])


def test_ttft_p95_takes_every_request():
    reqs = [Served(str(i), 0.0, first=0.1 * (i + 1), finish=1.0, tokens=2)
            for i in range(19)] + [Served("late", 0.0)]
    out = stats.end_to_end(reqs, tokens_in_window=100, window_s=4.0,
                           end=30.0)
    want = np.percentile([0.1 * (i + 1) for i in range(19)] + [30.0], 95)
    assert out["ttft_p95_ms"] == pytest.approx(want * 1e3)


def test_rate_is_over_the_whole_window():
    reqs = [Served("a", 0.0, first=0.1, finish=1.0, tokens=10)]
    out = stats.end_to_end(reqs, tokens_in_window=300, window_s=45.0,
                           end=50.0)
    assert out["output_tokens_per_s"] == pytest.approx(300 / 45.0)


def test_tpot_over_finished_requests_with_two_tokens_or_more():
    reqs = [Served("a", 0.0, first=1.0, finish=2.0, tokens=11),
            Served("b", 0.0, first=1.0, finish=1.0, tokens=1),
            Served("c", 0.0, first=1.0, finish=None, tokens=0)]
    assert stats.tpot_values(reqs) == pytest.approx([0.1])


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)
