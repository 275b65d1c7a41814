"""Window statistics: whole-window rates and tail percentiles."""

import pytest

from benchmark import stats
from benchmark.harness import Window


def test_rate_is_all_work_over_all_time():
    w = Window([0.0, 1.0, 2.5], [1.0, 2.5, 4.0], [0, 0, 0], [None] * 3, [])
    assert w.seconds == 4.0
    assert stats.window_rate(3 * 100, w.seconds) == 75.0
    with pytest.raises(ValueError):
        stats.window_rate(1, 0.0)


def test_p95_over_all_calls():
    calls = [float(v) for v in range(1, 201)]  # 200 samples
    assert stats.percentile(calls, 95) == pytest.approx(190.05)
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)
