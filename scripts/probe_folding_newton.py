"""Trace the port's Newton loop on the folding scene's first step: per
iteration max|p|/dt, the accepted energy and the line-search trials.

    PYTHONPATH=. python scripts/probe_folding_newton.py [--f64] [--device cuda]
    PYTHONPATH=. python scripts/probe_folding_newton.py --reference

The port's own `solver.newton_solve` runs, with its solve and line search
wrapped to record each iteration. --reference runs the same loop on the JAX
package's functions (its solve, line-search energy and step rule, on the
CPU) instead, for comparison.
"""
import argparse

import numpy as np


def port_trace(dtype, device):
    import torch

    from thinshelllab_torch.engine import elements, solver, stepper
    from thinshelllab_torch.scenes import registry

    sc = registry.make_scene("folding", solver="auto", dtype=dtype)
    spec, s0, params = sc.to(device)
    contact, _, _ = stepper.build_contacts(spec, params, s0.pos, s0.pos,
                                           s0.proj_flag, s0.proj_dir)
    rows, trials = [], []
    solve, energy_fn = solver.solve_linear, elements.linesearch_energy_fn

    def traced_solve(*a, **k):
        out = solve(*a, **k)
        p = out[0] if isinstance(out, tuple) else out
        rows.append(float(torch.amax(torch.abs(p))) / spec.dt)
        trials.append([])
        return out

    def traced_energy(*a, **k):
        E_of = energy_fn(*a, **k)

        def run(alpha):
            E = E_of(alpha)
            trials[-1].append(float(E))
            return E

        return run

    solver.solve_linear = traced_solve
    elements.linesearch_energy_fn = traced_energy
    try:
        solver.newton_solve(spec, params, s0.pos, s0.pos, s0.vel,
                            s0.ref_angle, contact)
    finally:
        solver.solve_linear = solve
        elements.linesearch_energy_fn = energy_fn
    return spec.newton_tol, [(d, t[-1], len(t)) for d, t in zip(rows, trials)]


def reference_trace(f64):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from thinshelllab_tpu.engine import elements, solver, stepper
    from thinshelllab_tpu.scenes import folding

    dt = jnp.float64 if f64 else jnp.float32
    sc = folding.make(dtype=dt, solver="dense")
    spec, params = sc.spec, sc.params
    s0 = jax.tree.map(jnp.asarray, sc.state0)
    contact, _, _ = stepper.build_contacts(spec, params, s0.pos, s0.pos,
                                           s0.proj_flag, s0.proj_dir)
    pos0, vel, ref = s0.pos, s0.vel, s0.ref_angle
    pos = jnp.where(jnp.asarray(spec.frozen), pos0, pos0 + vel * spec.dt)

    @jax.jit
    def direction(pos):
        g = elements.all_groups(spec, params, pos, ref, contact,
                                with_hess=True, spd=True)
        F = elements.assemble_residual(spec, g, pos, pos0, vel)
        return solver.solve_dense(spec, g, F)

    @jax.jit
    def energy(pos, p, a):
        return elements.linesearch_energy_fn(spec, params, pos, p, pos0, vel,
                                             ref, contact)(a)

    E0 = elements.total_energy(spec, params, pos, pos0, vel, ref, contact)
    rows, delta, it = [], 1e5, 0
    while it < spec.max_newton_iter and delta >= spec.newton_tol:
        p = direction(pos)
        delta = float(jnp.max(jnp.abs(p))) / spec.dt
        alpha, n = 1.0, 0
        while True:
            E = energy(pos, p, jnp.asarray(alpha, pos.dtype))
            n += 1
            applied = alpha
            if bool(E < E0):
                break
            alpha *= 0.5
            if not alpha > spec.linesearch_min_alpha:
                break
        pos = pos - jnp.asarray(applied, pos.dtype) * p
        E0 = E
        rows.append((delta, float(E), n))
        it += 1
    return spec.newton_tol, rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--reference", action="store_true",
                    help="the JAX package's functions on the CPU")
    args = ap.parse_args()
    if args.reference:
        tol, rows = reference_trace(args.f64)
    else:
        import torch

        tol, rows = port_trace(torch.float64 if args.f64 else torch.float32,
                               args.device)
    print(f"newton_tol {tol}")
    for i, (d, E, n) in enumerate(rows):
        print(f"{i:3d} max|p|/dt {d:.3e}  E {E:.9e}  line-search trials {n}")
    n = np.array([r[2] for r in rows])
    print(f"{len(rows)} iterations, {int(n.sum())} trials, "
          f"{int((n >= 27).sum())} failed line searches")


if __name__ == "__main__":
    main()
