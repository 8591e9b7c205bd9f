"""The window's arithmetic and the seeded sample."""

import numpy as np
import pytest

from renderbench import stats


def test_frame_ms():
    assert stats.frame_ms(10.0, 12.5, 100) == pytest.approx(25.0)
    with pytest.raises(ValueError):
        stats.frame_ms(0.0, 1.0, 0)


def test_intervals_and_p95():
    ev = [10.0, 20.0, 31.0, 40.0]
    assert stats.intervals(ev[0], ev) == [10.0, 10.0, 11.0, 9.0]
    vals = list(range(1, 101))
    assert stats.percentile(vals, 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0


def test_reservoir_is_seeded_and_uniform():
    def pick(seed, n):
        r = stats.Reservoir(2, np.random.default_rng(seed))
        for i in range(n):
            r.offer(i)
        return sorted(r.items)

    assert pick(1, 50) == pick(1, 50)
    assert pick(1, 1) == [0] and pick(1, 2) == [0, 1]
    hits = np.zeros(10)
    for s in range(4000):
        for i in pick(s, 10):
            hits[i] += 1
    assert hits.min() > 0.85 * 800 and hits.max() < 1.15 * 800
