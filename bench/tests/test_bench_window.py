"""The window arithmetic at hand-worked values."""

from __future__ import annotations

import pytest

from bench import harness


def test_rate_is_the_count_over_the_whole_window():
    assert harness.rate(450, 30.0) == 15.0
    with pytest.raises(ValueError):
        harness.rate(1, 0.0)


def test_p95_is_over_every_value():
    vals = list(range(1, 101))                  # 1..100
    assert harness.percentile(vals, 95) == pytest.approx(95.05)
    assert harness.percentile([3.0], 95) == 3.0
    # the order of the values does not matter, and no chunk medians are taken
    assert harness.percentile(vals[::-1], 95) == pytest.approx(95.05)
    assert harness.percentile([1.0] * 19 + [100.0], 95) == pytest.approx(5.95)


def test_union_and_idle_share_of_synthetic_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert harness.merge(iv) == [(0.0, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert harness.busy_in(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert harness.idle_share(iv, 0.0, 10.0) == pytest.approx(0.6)
    assert harness.busy_in(iv, 1.0, 3.5) == pytest.approx(1.5)
    assert harness.gaps_in(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]


def test_breakdown_names_the_innermost_host_op_of_each_gap():
    t = harness.Trace(t0=0.0, t1=10.0, steps=2,
                      kernels=[("k1", 0.0, 2.0), ("k2", 3.0, 4.0), ("k1", 8.0, 10.0)],
                      launches=3, syncs=1,
                      host_ops=[("step", 0.0, 10.0), ("argmax", 2.0, 3.0),
                                ("schedule", 4.5, 7.9)])
    b = harness.breakdown(t)
    assert b["device_ops"] == [["k1", 4.0], ["k2", 1.0]]
    assert b["idle_gaps"] == [["schedule", 4.0], ["argmax", 1.0]]
    assert t.busy_s == pytest.approx(5.0) and t.window_s == 10.0
