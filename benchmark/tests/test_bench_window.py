"""The window's arithmetic on a fake clock."""
import pytest

from benchmark.harness.window import Window, WindowClosed


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_rate_counts_units_that_end_before_the_close():
    clock = Clock()
    win = Window(10.0, clock=clock).open()
    for dt in (3.0, 3.0, 3.0):
        win.begin()
        clock.t += dt
        assert win.complete(4)
    assert not win.closed()
    win.begin()
    clock.t += 3.0  # ends at 12 s, after the close
    assert not win.complete(4)
    assert win.closed()
    assert win.steps == 12 and win.dropped == 1
    assert win.span_s == pytest.approx(9.0)
    assert win.rate() == pytest.approx(12 / 9.0)


def test_nothing_completed_gives_no_rate():
    clock = Clock()
    win = Window(1.0, clock=clock).open()
    clock.t += 2.0
    assert win.rate() is None and win.span_s is None
    with pytest.raises(WindowClosed):
        win.check()


def test_time_between_units_counts():
    clock = Clock()
    win = Window(10.0, clock=clock).open()
    clock.t += 1.0  # host work before the first unit
    win.begin()
    clock.t += 2.0
    win.complete(3)
    assert win.rate() == pytest.approx(3 / 3.0)
    assert win.units[0][:3] == (101.0, 103.0, 3)
