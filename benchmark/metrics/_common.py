"""Arithmetic the per-layer readers share (not a metric: no manifest name
starts with '_')."""
from __future__ import annotations

from ..harness import spans


def mean(values):
    values = list(values)
    return sum(values) / len(values) if values else None


def flat(units, key):
    return [x for u in units for x in u.get(key, [])]


def newton_iterations(units):
    return sum(flat(units, "newton_per_step"))


def span_seconds(units, label, within):
    return sum(spans.seconds(u.get("spans", {}), label, within)
               for u in units)


def ms_per_newton(rec, labels, within, minus=()):
    """Milliseconds a forward Newton iteration spends in the spans
    `labels` opened inside the span `within`, less the nested spans
    `minus`, over the units outside the profiler; None without a Newton
    iteration or a span."""
    units = rec.timed_units()
    n = newton_iterations(units)
    secs = sum(span_seconds(units, lab, within) for lab in labels)
    secs -= sum(span_seconds(units, lab, within) for lab in minus)
    if not n or secs <= 0:
        return None
    return 1e3 * secs / n
