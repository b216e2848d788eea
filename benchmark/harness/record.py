"""What a run records for the per-layer metrics.

In a traced run (--trace 1) every unit of the window runs inside a "unit"
span, the program functions that the cell's metrics name are wrapped in
spans (harness.spans), and the first unit runs under torch.profiler: the
profiler's window is that unit. Untraced runs install nothing but the
window's own clock."""
from __future__ import annotations

import contextlib
import importlib
import time

from . import trace as trace_mod
from .spans import Spans

UNIT = "unit"


class Record:
    def __init__(self, traced: bool):
        self.traced = traced
        self.spans = Spans()
        self.units = []          # the window's counted units' infos
        self.device = None       # reduce_profile of the profiled unit
        self.traced_steps = 0    # steps of the profiled unit
        self.unit_spans = {}     # spans of the last unit, {path: (s, n)}
        self.window = None       # the harness.window.Window
        self.setup_s = None
        self.reduce_s = None     # seconds the profiler's reduction took
        self.check_s = None      # seconds the output check took
        self.numbers = None      # every number the output check computed
        self._profiled = False
        self._prof = None
        self._unit_profiled = False

    def install(self, targets):
        """Wrap (module path, attribute path, label) targets in spans; the
        attribute path may name a class attribute ("Class.method")."""
        if not self.traced:
            return
        for mod_name, attr, label in targets:
            owner = importlib.import_module(mod_name)
            *outer, name = attr.split(".")
            for part in outer:
                owner = getattr(owner, part)
            self.spans.wrap(owner, name, label)

    def restore(self):
        self.spans.restore()

    @contextlib.contextmanager
    def unit(self, steps):
        """One unit of `steps` simulated steps: a span in a traced run, and
        under the profiler for the first unit. A unit cut short by the
        window's close leaves no device reading."""
        self.unit_spans = {}
        self._unit_profiled = False
        if not self.traced:
            yield
            return
        snap = self.spans.snapshot()
        if self._profiled:
            with self.spans.span(UNIT):
                yield
        else:
            from torch.profiler import ProfilerActivity, profile

            self._profiled = True
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            try:
                with self.spans.span(UNIT):
                    yield
            except BaseException:
                prof.stop()
                raise
            t0 = time.perf_counter()
            prof.stop()
            # the profiler's stop is no work of the unit's: the window
            # closes that much later
            if self.window is not None:
                self.window.deadline += time.perf_counter() - t0
            self._prof = prof
            self.traced_steps = steps
            self._unit_profiled = True
        self.unit_spans = self.spans.since(snap)

    def reduce_trace(self):
        """Reduce the profiled unit's trace (after the window)."""
        if self._prof is not None:
            t0 = time.perf_counter()
            self.device = trace_mod.reduce_profile(self._prof, UNIT)
            self.reduce_s = time.perf_counter() - t0
            self._prof = None

    def count(self, unit):
        """Keep a counted unit's info, with the spans it recorded and
        whether it ran under the profiler."""
        unit["spans"] = self.unit_spans
        unit["profiled"] = self._unit_profiled
        self.units.append(unit)

    def timed_units(self):
        """The counted units for a time a unit: those outside the profiler
        (which slows a unit about twice), or all where none is."""
        plain = [u for u in self.units if not u.get("profiled")]
        return plain or self.units
