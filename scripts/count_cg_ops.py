"""Operators dispatched by one CG iteration of a task scene under
solver="cg", on the CPU, with the card's operator structure: the DIA
kernels' wrappers stand in for one launch each (their plain versions run
uncounted), so the count is what a CG iteration launches on the card,
views included. One forward step, the Newton cap cut to 1 and CG to
`cg_iters` iterations.

Prints the operators a CG iteration and per operator name, with the
contact split the CPU builds (JAX's, with 'mm' selection-matmul pairs)
and with the card's (`contact_static_split(mm=False)`), and the
operators of the rest of the step (assembly, contacts, line search).

Usage: PYTHONPATH=. python scripts/count_cg_ops.py [scene] [cg_iters]
"""
import collections
import dataclasses
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as cs
from thinshelllab_torch.engine import elements, plans, solver, stepper
from thinshelllab_torch.ops import dia_spmv as K


class Count(TorchDispatchMode):
    """Counts every dispatched operator outside the kernels' stand-ins."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.inner = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.inner == 0:
            self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))

    def stand_in(self, fn, label):
        def call(*a, **k):
            self.counts[label] += 1
            self.inner += 1
            try:
                return fn(*a, **k)
            finally:
                self.inner -= 1
        return call


def count(name, cg_iters, mm):
    mode = Count()
    sc = cs.cg_scene(name, torch.device("cpu"))
    spec, s0, params = sc.to("cpu")
    spec = spec.replace(max_newton_iter=1, cg_max_iter=cg_iters, dev=(
        dataclasses.replace(spec.dev, contact_split=plans.contact_static_split(
            sc.spec, mm=mm))))
    acts = tuple(a[:1] for a in cs.cg_actions(name, sc.n_part, spec.dtype,
                                             torch.device("cpu")))
    saved = (K.dia_spmv, K.dia_precond, elements.use_spmv_kernel,
             solver._pcg_loop)
    in_loop, its = collections.Counter(), [0]

    def pcg(*a, **k):
        before = mode.counts.copy()
        out = saved[3](*a, **k)
        its[0] += out[1]
        in_loop.update(mode.counts - before)
        return out

    K.dia_spmv = mode.stand_in(
        lambda dia, x2, offs, offs_t=None: K.dia_spmv_plain(dia, x2, offs),
        "dia_spmv")
    K.dia_precond = mode.stand_in(
        lambda dp, r2, u2, di, offs, w, sw, offs_t=None:
        K.dia_precond_plain(dp, r2, u2, di, offs, w, sw), "dia_precond")
    elements.use_spmv_kernel = lambda spec, x: spec.dia is not None
    solver._pcg_loop = pcg
    try:
        with mode:
            stepper.simulate(spec, params, s0, acts)
    finally:
        (K.dia_spmv, K.dia_precond, elements.use_spmv_kernel,
         solver._pcg_loop) = saved
    n = max(its[0], 1)
    split = spec.dev.contact_split
    print(f"{name} mm={mm} ('mm' pairs {len(split[1]) if split else 0}): "
          f"{its[0]} CG iterations, {sum(in_loop.values()) / n:.1f} "
          f"operators a CG iteration; the rest of the step "
          f"{sum((mode.counts - in_loop).values())} operators")
    for op, c in in_loop.most_common(12):
        print(f"  {op:24s} {c / n:7.2f}")


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "sliding"
    cg_iters = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    for mm in (True, False):
        count(name, cg_iters, mm)


if __name__ == "__main__":
    main()
