"""The measured window and its arithmetic.

A window opens, runs units of work (a trajopt iteration) for
`seconds`, and closes. A unit counts when it completes before the close;
the one in flight at the close is dropped, not failed. A rate is the
steps of every counted unit over the time from the window's start to the
end of the last counted unit, so a unit cut at the close neither counts
nor stretches the denominator."""
from __future__ import annotations

import time


class WindowClosed(Exception):
    """Raised where a unit of work would start or end after the close."""


class Window:
    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds = float(seconds)
        self.clock = clock
        self.t0 = None
        self.deadline = None
        self.units = []     # (start, end, steps, info) of counted units
        self.dropped = 0    # units that ended after the close
        self._start = None

    def open(self):
        self.t0 = self._start = self.clock()
        self.deadline = self.t0 + self.seconds
        return self

    def closed(self) -> bool:
        return self.clock() >= self.deadline

    def check(self):
        """Raise WindowClosed when the window has closed."""
        if self.closed():
            raise WindowClosed

    def begin(self):
        """Mark the start of a unit (the previous unit's end by default)."""
        self._start = self.clock()

    def complete(self, steps: int, info=None) -> bool:
        """Count a unit that has just ended (its results already waited
        for). False, and the unit dropped, when it ended after the close."""
        end = self.clock()
        if end > self.deadline:
            self.dropped += 1
            return False
        self.units.append((self._start, end, int(steps), info))
        self._start = end
        return True

    @property
    def steps(self) -> int:
        return sum(u[2] for u in self.units)

    @property
    def span_s(self):
        """Seconds from the window's start to the end of its last counted
        unit; None when no unit completed."""
        return self.units[-1][1] - self.t0 if self.units else None

    def rate(self):
        """Steps a second over span_s; None when no unit completed."""
        span = self.span_s
        return self.steps / span if span else None
