"""The output check: numbers compared with their limits.

A cell's limits are limits/<workload>.json, {number: {"limit": x,
"lower": reading, "upper": reading}}: the limit lies between the largest
reading of sound runs of the program ("lower") and the smallest reading of
the control ("upper"); PERF.md gives both. A limit of 0 is an exact
comparison. A run is correct when every
number is finite and at most its limit. Every number is printed beside its
limit, on standard error and in the result line."""
from __future__ import annotations

import math

import numpy as np
import torch


def max_abs_gap(a, b):
    """max |a - b| over every entry (float64 on the host)."""
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    if a.shape != b.shape:
        return math.inf
    return float((a - b).abs().max()) if a.numel() else 0.0


def rel_gap(a, b):
    """|a - b| / |b| in the 2-norm; 0 where both are 0, inf where only b
    is."""
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    if a.shape != b.shape:
        return math.inf
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    if den == 0.0:
        return 0.0 if num == 0.0 else math.inf
    return num / den


def mismatches(a, b):
    """Entries that differ (shape mismatch: every entry)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))


def judge(numbers, limits):
    """(correct, rows): rows are (name, value, limit) for every number the
    cell's limits hold, in their order; a driver's number that they do
    not name is not compared. A limit without a number is not correct."""
    rows, ok = [], True
    for name, spec in limits.items():
        value = numbers.get(name)
        limit = spec["limit"]
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows


def lines(rows):
    return [f"check {name}: {value!r} (limit {limit!r})"
            for name, value, limit in rows]


def as_json(rows):
    return {name: {"value": value, "limit": limit}
            for name, value, limit in rows}
