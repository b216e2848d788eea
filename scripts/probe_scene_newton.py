"""Trace the port's Newton loop on the first steps of task scenes, as
`cli trajopt` starts them (a zero waypoint table, so zero actions; the
balancing scenes from the bundled grasp): per Newton iteration max|p|/dt,
the accepted energy, the line-search trials, whether the element
Hessians, the dense Hessian, the residual and the direction are finite,
how often the eigensolver refused a batch (ops/spd._eigh then solves it
again on the host) and how often it returned non-finite values for finite
blocks.

    PYTHONPATH=. python scripts/probe_scene_newton.py sliding lifting \
        [--steps 2] [--f64] [--device cuda]

Float32 on the card is the default, as the CLI runs there.
"""
import argparse

import torch

from thinshelllab_torch.engine import elements, solver, stepper
from thinshelllab_torch.scenes import balancing, registry
from thinshelllab_torch.utils import checkpoint


def finite(t):
    return bool(torch.isfinite(t).all())


def trace(name, dtype, device, steps):
    sc = registry.make_scene(name, solver="auto", dtype=dtype)
    if name in ("balancing", "balance", "throwing"):
        sc.state0 = checkpoint.load_state(balancing.bundled_state_path(),
                                          dtype, device)
    spec, state, params = sc.to(device)
    rows = []
    solve, energy_fn, eigh = (solver.solve_linear,
                              elements.linesearch_energy_fn,
                              torch.linalg.eigh)
    refused, nonfinite = [0], [0]

    def counted_eigh(h):
        try:
            w, v = eigh(h)
        except torch.linalg.LinAlgError:
            refused[0] += 1
            raise
        if not (finite(w) and finite(v)) and finite(h):
            nonfinite[0] += 1
        return w, v

    def traced_solve(spec_, groups, F, **k):
        out = solve(spec_, groups, F, **k)
        p = out[0] if isinstance(out, tuple) else out
        rows.append(dict(d=float(torch.amax(torch.abs(p))) / spec.dt,
                         fin=(finite(groups["H"]),
                              finite(elements.dense_hessian(spec_, groups)),
                              finite(F), finite(p)),
                         refused=refused[0], nonfinite=nonfinite[0], E=[]))
        return out

    def traced_energy(*a, **k):
        E_of = energy_fn(*a, **k)

        def run(alpha):
            E = E_of(alpha)
            rows[-1]["E"].append(float(E))
            return E

        return run

    solver.solve_linear = traced_solve
    elements.linesearch_energy_fn = traced_energy
    torch.linalg.eigh = counted_eigh
    n = sc.n_part
    act = tuple(torch.zeros(s, dtype=dtype, device=device)
                for s in ((n, 3), (n, 3), (n,)))
    try:
        for t in range(steps):
            rows.clear()
            refused[0] = nonfinite[0] = 0
            state, _ = stepper.time_step(spec, params, state, act)
            print(f"{name} {dtype} step {t + 1}: newton_tol "
                  f"{spec.newton_tol}, {len(rows)} iterations, positions "
                  f"finite {finite(state.pos)}")
            for i, r in enumerate(rows):
                E = r["E"][-1] if r["E"] else float("nan")
                print(f"  {i:3d} max|p|/dt {r['d']:.3e}  E {E:.9e}  trials "
                      f"{len(r['E'])}  finite (element H, dense H, F, p) "
                      f"{r['fin']}  eigh calls refused / non-finite on "
                      f"finite input so far {r['refused']} / "
                      f"{r['nonfinite']}")
    finally:
        solver.solve_linear = solve
        elements.linesearch_energy_fn = energy_fn
        torch.linalg.eigh = eigh


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="+")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dtype = torch.float64 if args.f64 else torch.float32
    for name in args.names:
        trace(name, dtype, torch.device(args.device), args.steps)


if __name__ == "__main__":
    main()
