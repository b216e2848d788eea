"""Tracing / profiling utilities (counterpart of
`thinshelllab_tpu/utils/profiling.py`).

The reference's only instrumentation is wall-clock prints
(trajopt_folding.py:83,105; Scene_lifting.time_step:177-231). Here: phase
timers that wait for the card, a torch.profiler trace context that writes
a Chrome trace, and the flop count and peak memory of one call.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _synchronize(sync):
    """Wait for the devices of a tensor or a tuple of tensors (CPU tensors
    need nothing)."""
    for t in sync if isinstance(sync, (tuple, list)) else (sync,):
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


class PhaseTimer:
    """Accumulating wall-clock phase timer (device-synchronizing)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time the block; with `sync` (a tensor or a tuple of tensors) the
        clock stops once their devices have finished."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:>24}: {tot:8.3f}s total, {tot/n*1e3:8.2f}ms/call x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler over the block (CPU and, with a card, CUDA
    activities); writes a Chrome trace (trace.json, chrome://tracing or
    Perfetto) into log_dir. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def compiled_stats(fn, *args, **kwargs):
    """The counterpart of XLA's cost and memory analysis of one call of
    fn(*args, **kwargs): {"cost": {"flops": ...}, "memory": {"peak_bytes":
    ...}} from torch.utils.flop_counter.FlopCounterMode, and the peak of
    torch.cuda.max_memory_allocated over the call when an argument lies on
    the card (None otherwise)."""
    from torch.utils.flop_counter import FlopCounterMode

    cuda = [a.device for a in (*args, *kwargs.values())
            if isinstance(a, torch.Tensor) and a.device.type == "cuda"]
    if cuda:
        torch.cuda.synchronize(cuda[0])
        torch.cuda.reset_peak_memory_stats(cuda[0])
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    peak = None
    if cuda:
        torch.cuda.synchronize(cuda[0])
        peak = torch.cuda.max_memory_allocated(cuda[0])
    return {"cost": {"flops": counter.get_total_flops()},
            "memory": {"peak_bytes": peak}}
