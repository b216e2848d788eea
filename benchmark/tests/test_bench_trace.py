"""The profiler's reduction on synthetic intervals."""
import pytest

from benchmark.harness.trace import reduce_events


def test_busy_is_the_union_inside_the_window():
    dev = [(0.0, 2.0, "a"), (1.0, 3.0, "b"), (5.0, 6.0, "a"),
           (9.5, 11.0, "c")]
    r = reduce_events(dev, [], 0.0, 10.0)
    assert r["busy_s"] == pytest.approx(3.0 + 1.0 + 0.5)
    assert r["window_s"] == 10.0
    assert r["ops"] == 4
    assert r["seconds_by_name"]["a"] == pytest.approx(3.0)
    assert r["breakdown"]["device_ops"][0] == ["a", 3.0]


def test_idle_gaps_are_named_by_the_innermost_open_span():
    dev = [(0.0, 1.0, "k"), (4.0, 5.0, "k"), (8.0, 10.0, "k")]
    host = [(0.0, 10.0, "unit"), (1.0, 6.0, "forward"),
            (2.0, 3.0, "all_groups"), (6.0, 9.0, "backward")]
    r = reduce_events(dev, host, 0.0, 10.0)
    gaps = dict((n, s) for n, s in r["breakdown"]["idle_gaps"])
    # 1-4 s begins inside forward, 5-8 s inside forward (its span ends
    # at 6); nothing begins inside all_groups or backward
    assert gaps == {"forward": pytest.approx(6.0)}
    assert r["busy_s"] == pytest.approx(4.0)


def test_gap_outside_every_span():
    r = reduce_events([(2.0, 3.0, "k")], [(0.0, 1.0, "setup")], 1.0, 4.0)
    names = [n for n, _ in r["breakdown"]["idle_gaps"]]
    assert names == ["outside any span"]
    assert r["breakdown"]["idle_gaps"][0][1] == pytest.approx(2.0)
