"""The published folding scene's contact threshold tie, the JAX package
against the port, in f64 on the CPU: the contact slots whose active flag or
triangle differ at the initial state, each query vertex's gap against
eps_contact, and a 2-step rollout with zero actions in both packages.

    PYTHONPATH=. python scripts/probe_folding_contacts.py [--table_n 9]

The flat rows of the cloth lie at z = 0.0004 m = eps_contact above the
table top (z = 0), so a table vertex under the cloth has gap ==
eps_contact up to rounding, and `active = gap < eps_contact` is decided
by the last bit.
"""
import argparse

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from thinshelllab_tpu.engine import stepper as jstepper  # noqa: E402
from thinshelllab_tpu.scenes import folding as jfolding  # noqa: E402
from thinshelllab_torch.engine import stepper  # noqa: E402
from thinshelllab_torch.scenes import folding  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--table_n", type=int, default=9)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    jsc, sc = jfolding.make(table_n=args.table_n), folding.make(
        table_n=args.table_n)
    spec, s0, params = sc.to("cpu")
    j0 = jax.tree.map(jnp.asarray, jsc.state0)
    jc, _, _ = jstepper.build_contacts(jsc.spec, jsc.params, j0.pos, j0.pos,
                                       j0.proj_flag, j0.proj_dir)
    tc, _, _ = stepper.build_contacts(spec, params, s0.pos, s0.pos,
                                      s0.proj_flag, s0.proj_dir)
    ja, ta = np.asarray(jc.active), tc.active.numpy()
    ji, ti = np.asarray(jc.idx), tc.idx.numpy()
    bad = np.flatnonzero((ja != ta) | (np.any(ji != ti, axis=1) & (ja | ta)))
    cq = np.asarray(jsc.spec.contact.cq_vert)
    pos = np.asarray(j0.pos)
    print(f"table_n {args.table_n}: {ja.size} contact slots, active JAX "
          f"{int(ja.sum())}, port {int(ta.sum())}; {bad.size} slots differ")
    for k in bad:
        print(f"  slot {k}: query vertex {cq[k]} at {pos[cq[k]].tolist()}, "
              f"JAX active {bool(ja[k])} tri {ji[k, :3].tolist()}, port "
              f"active {bool(ta[k])} tri {ti[k, :3].tolist()}")
    T = args.steps
    acts = (np.zeros((T, 1, 3)), np.zeros((T, 1, 3)), np.zeros((T, 1)))
    _, jb = jax.jit(lambda s, a: jstepper.simulate(jsc.spec, jsc.params, s,
                                                   a))(
        j0, tuple(jnp.asarray(a) for a in acts))
    _, tb = stepper.simulate(spec, params, s0,
                             tuple(torch.as_tensor(a) for a in acts))
    for t in range(T + 1):
        d = np.abs(np.asarray(jb["pos"][t]) - tb["pos"][t].numpy()).max()
        print(f"  step {t}: max |dpos| {d:.3e} m")
    print(f"reward after {T} steps: JAX {float(jsc.reward(jb)):.6f}, port "
          f"{float(sc.reward(tb)):.6f}")


if __name__ == "__main__":
    main()
