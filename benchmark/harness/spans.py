"""Spans from the benchmark's own files around calls into the program.

`Spans.wrap(owner, attr, label)` replaces a function or method of the
program by a wrapper that waits for the card before and after the call
(so the span holds the device work the call queued), adds the wall time
to the span's path (the labels of the open spans, joined by '/'), and
opens a torch.profiler.record_function range of the same label, by which
the profiler's idle gaps are named. `restore()` puts every original back.
The open span stack is also what names the host's work in an idle gap."""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict

import torch

PREFIX = "bench:"


class Spans:
    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.total = defaultdict(float)   # path -> seconds
        self.count = defaultdict(int)     # path -> calls
        self.stack = []
        self._patched = []

    @staticmethod
    def _wait():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, label):
        path = "/".join(self.stack + [label])
        self._wait()
        self.stack.append(label)
        t0 = self.clock()
        try:
            with torch.profiler.record_function(PREFIX + label):
                yield
                self._wait()
        finally:
            self.total[path] += self.clock() - t0
            self.count[path] += 1
            self.stack.pop()

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with self.span(label):
                return fn(*args, **kwargs)

        setattr(owner, attr, wrapper)
        self._patched.append((owner, attr, fn))

    def restore(self):
        while self._patched:
            owner, attr, fn = self._patched.pop()
            setattr(owner, attr, fn)

    def snapshot(self):
        return dict(self.total), dict(self.count)

    def since(self, snap):
        """{path: (seconds, calls)} recorded since snapshot()."""
        total0, count0 = snap
        return {p: (self.total[p] - total0.get(p, 0.0),
                    self.count[p] - count0.get(p, 0))
                for p in self.total if self.count[p] > count0.get(p, 0)}


def seconds(spans, label, within=None):
    """Seconds in the spans of `spans` ({path: (seconds, calls)}) whose
    path ends in `label`, inside a span labelled `within` when given."""
    return sum(v[0] for p, v in spans.items() if _match(p, label, within))


def calls(spans, label, within=None):
    return sum(v[1] for p, v in spans.items() if _match(p, label, within))


def _match(path, label, within):
    parts = path.split("/")
    return parts[-1] == label and (within is None or within in parts[:-1])
