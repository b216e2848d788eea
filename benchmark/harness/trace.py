"""The profiler's trace of the card, reduced to the numbers the metrics
read: device busy seconds over the traced window, operations on the
device by name, launches, idle gaps named by the benchmark span open on
the host, and the `breakdown` of the result line.

`reduce_events` is plain arithmetic on (start, end, name) intervals, so it
is tested on the CPU; `reduce_profile` reads a torch.profiler run."""
from __future__ import annotations

from collections import defaultdict

from .spans import PREFIX


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class _OpenSpans:
    """The innermost host span open at a time, for times asked in rising
    order. The benchmark's spans nest (one host thread), so the open ones
    form a stack."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.i = 0
        self.stack = []

    def at(self, t):
        while self.i < len(self.spans) and self.spans[self.i][0] <= t:
            span = self.spans[self.i]
            while self.stack and self.stack[-1][1] <= span[0]:
                self.stack.pop()
            self.stack.append(span)
            self.i += 1
        while self.stack and self.stack[-1][1] <= t:
            self.stack.pop()
        return self.stack[-1][2] if self.stack else "outside any span"


def reduce_events(device, host, t0, t1, top=10):
    """device: (start, end, name) of every operation on the card; host:
    (start, end, label) of the benchmark's spans; [t0, t1) the traced
    window; times in seconds on one clock.

    Returns busy_s (the union of device intervals inside the window),
    window_s, ops (device operations in the window), per-name device
    seconds and counts, and the breakdown lists: the device operations
    that took most time, and the idle seconds summed by the host span
    open when each gap began."""
    inside = [(max(s, t0), min(e, t1), n) for s, e, n in device
              if e > t0 and s < t1]
    merged = _union((s, e) for s, e, _ in inside)
    busy = sum(e - s for s, e in merged)
    by_name = defaultdict(float)
    counts = defaultdict(int)
    for s, e, n in inside:
        by_name[n] += e - s
        counts[n] += 1
    idle = defaultdict(float)
    open_spans = _OpenSpans(host)
    cursor = t0
    for s, e in merged + [[t1, t1]]:
        if s > cursor:
            idle[open_spans.at(cursor)] += s - cursor
        cursor = max(cursor, e)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy,
        "window_s": t1 - t0,
        "ops": len(inside),
        "seconds_by_name": dict(by_name),
        "count_by_name": dict(counts),
        "breakdown": {"device_ops": [[n, s] for n, s in device_ops],
                      "idle_gaps": [[n, s] for n, s in gaps]},
    }


def _ns(ev, which):
    fn = getattr(ev, f"{which}_ns", None)
    if fn is not None:
        return fn()
    return getattr(ev, f"{which}_us")() * 1e3


def _annotation(ev):
    kind = getattr(ev, "activity_type", None)
    return kind is not None and "annotation" in str(kind()).lower()


def _short(name, n=120):
    """A kernel's name cut to n characters (templated names run to
    thousands)."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= n else name[:n - 3] + "..."


def reduce_profile(prof, window_label):
    """Reduce a torch.profiler run whose traced window is the benchmark
    span `window_label`. Returns None when the trace holds no device
    operation (the caller then reports the device metrics as not
    measured)."""
    from torch.autograd import DeviceType

    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, "start") * 1e-9
        end = start + _ns(ev, "duration") * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            # the benchmark's spans are mirrored on the card's timeline as
            # annotations: no operation ran there
            if not (name.startswith(PREFIX) or _annotation(ev)):
                device.append((start, end, _short(name)))
        elif name.startswith(PREFIX):
            label = name[len(PREFIX):]
            host.append((start, end, label))
            if label == window_label:
                window = (start, end)
    if not device or window is None:
        return None
    return reduce_events(device, host, *window)
