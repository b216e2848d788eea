"""Contact threshold ties of a task scene at its published size, in f64 on
the CPU: the found contact slots whose gap lies within 1e-12 m of
eps_contact, where `active = gap < eps_contact` is decided by the last
bit, at the initial state and after one step of the JAX smoke test's
actions (pads 0.2 mm down). With --reference the same contact sets are
built by the JAX package on the same positions, and the slots whose
active flag or triangle differ between the packages are counted, split
into the part the projection's triangle choice makes and the part the
gap expression makes; it also prints how often XLA's CPU code (which
fuses multiply-adds) rounds a*b - c*d and the barycentric einsum
otherwise than PyTorch's.

    PYTHONPATH=. python scripts/probe_scene_ties.py sliding
    PYTHONPATH=. python scripts/probe_scene_ties.py sliding --reference
    PYTHONPATH=. python scripts/probe_scene_ties.py sliding --golden

With --golden it runs the 2-step rollout of
tests/test_torch_scene_rollouts.py and prints how far it parts from the
saved JAX run at each step.

Without --reference it imports no JAX.
"""
import argparse

import numpy as np
import torch

from thinshelllab_torch.engine import stepper
from thinshelllab_torch.ops import collision
from thinshelllab_torch.scenes import registry

TIE = 1e-12


def smoke_actions(n_part, T=1):
    dpos = np.zeros((T, n_part, 3))
    dpos[:, :, 2] = -0.0002
    return dpos, np.zeros((T, n_part, 3)), np.zeros((T, n_part))


def port_sets(spec, params, pos, flag, dirs):
    """(proj_flag, proj_dir, tri, w, ContactSet, gap) of the port."""
    vn = collision.vertex_normals(pos, spec.faces, spec.NV)
    f, d, tri, w = collision.projection_query(spec, pos, vn, flag, dirs)
    c = collision.contact_analysis(spec, params.mu_pairs, pos, pos, f, d,
                                   tri, w)
    return f, d, tri, w, c, _gap(c, pos)


def _gap(c, pos):
    x_c = torch.einsum("ck,ckd->cd", c.w, pos[c.idx[:, :3]])
    return torch.sum((pos[c.idx[:, 3]] - x_c) * c.n, dim=1)


def report_ties(tag, spec, flag, c, gap):
    """The found slots (proj_flag 1) whose gap lies within TIE of
    eps_contact."""
    found = (flag == 1).numpy()
    near = (torch.abs(gap - spec.eps_contact) < TIE).numpy() & found
    act = c.active.numpy()
    print(f"  {tag}: {int(near.sum())} of {int(found.sum())} found slots "
          f"within {TIE:g} m of eps_contact ({int((near & act).sum())} of "
          f"them active); {int(act.sum())} active of {act.size} slots")
    return near


def reference_split(name, tag, pos, flag, dirs, port):
    """Slots where the JAX package's contact set on the same inputs
    differs from the port's."""
    import jax
    import jax.numpy as jnp

    from thinshelllab_tpu.ops import collision as jcol
    from thinshelllab_tpu.scenes import registry as jregistry

    jsc = jregistry.make_scene(name, solver="auto")
    jspec, jparams = jsc.spec, jsc.params

    @jax.jit
    def jsets(p, fl, di):
        vn = jcol.vertex_normals(p, jnp.asarray(jspec.faces), jspec.NV)
        f, d, tri, w = jcol.projection_query(jspec, p, vn, fl, di)
        return f, d, tri, w, jcol.contact_analysis(
            jspec, jparams.mu_pairs, p, p, f, d, tri, w)

    jp = jnp.asarray(pos.numpy())
    jf, jd, jt, jw, jc = jsets(jp, jnp.asarray(flag.numpy(), jnp.int32),
                               jnp.asarray(dirs.numpy(), jnp.int32))
    _f, _d, tt, tw, tc, _g = port
    ja, ta = np.asarray(jc.active), tc.active.numpy()
    tri_diff = np.any(np.asarray(jt) != tt.numpy(), axis=1)
    # the gap expression alone: the JAX package's own contact analysis on
    # the port's triangles
    jc_on_port = jax.jit(lambda p, f, d, t, w: jcol.contact_analysis(
        jspec, jparams.mu_pairs, p, p, f, d, t, w))(
        jp, jf, jd, jnp.asarray(tt.numpy(), jnp.int32),
        jnp.asarray(tw.numpy()))
    expr = np.asarray(jc_on_port.active) != ta
    both = tri_diff & ja & ta
    dn = (float(np.abs(np.asarray(jc.n)[both] - tc.n.numpy()[both]).max())
          if both.any() else 0.0)
    print(f"  {tag}: active differs in {int((ja != ta).sum())} slots (JAX "
          f"{int(ja.sum())}, port {int(ta.sum())}); triangle differs in "
          f"{int((tri_diff & (ja | ta)).sum())} active slots (contact "
          f"normals there differ by up to {dn:.3e}); on the same "
          f"triangles the gap expression alone splits {int(expr.sum())}")
    return jsc


def rounding_check(n=100_000, seed=0):
    """How often XLA's CPU code rounds a multiply-add otherwise than the
    same operations one at a time (numpy, PyTorch's CPU kernels): a jitted
    a*b - c*d, and the einsum of three barycentric weights with a
    triangle's vertices as contact_analysis writes it."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    a, b, c, d = (rng.normal(size=n) for _ in range(4))
    fused = np.asarray(jax.jit(lambda a, b, c, d: a * b - c * d)(a, b, c, d))
    w, P = rng.random(size=(n, 3)), rng.normal(size=(n, 3, 3))
    xla = np.asarray(jnp.einsum("ck,ck...->c...", jnp.asarray(w),
                                jnp.asarray(P)))
    port = torch.einsum("ck,ckd->cd", torch.as_tensor(w),
                        torch.as_tensor(P)).numpy()
    print(f"rounding: a jitted a*b - c*d differs from numpy's in "
          f"{int((fused != a * b - c * d).sum())} of {n} random f64 inputs; "
          f"the weights' einsum differs between JAX and the port in "
          f"{int((xla != port).sum())} of {3 * n} entries")


def golden_split(name, sc, spec, s0, params):
    """The port's run of tests/test_torch_scene_rollouts.py (T=2, the
    smoke actions, max_newton_iter=5, f64) against the JAX run saved in
    tests/data/scenes_golden.npz: max |dpos| per step, and for a scene
    whose JAX tape is saved there, the slots whose active flag differs
    between the two tapes' contact sets per step."""
    import os

    z = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "data", "scenes_golden.npz"))
    g = {k[len(name) + 1:]: z[k] for k in z.files
         if k.startswith(name + ".")}
    spec5 = spec.replace(max_newton_iter=5)
    if name == "balancing":
        from thinshelllab_torch.scenes import balancing
        from thinshelllab_torch.utils import checkpoint

        s0 = checkpoint.load_state(balancing.bundled_state_path(),
                                   spec.dtype, "cpu").to("cpu", spec.dtype)
    acts = tuple(torch.as_tensor(a) for a in smoke_actions(sc.n_part, T=2))
    _, buf = stepper.simulate(spec5, params, s0, acts, save_contacts=True)
    d = np.abs(buf["pos"].numpy() - g["pos"]).max(axis=(1, 2))
    print(f"  against the JAX golden run (T=2, max_newton_iter=5): max "
          f"|dpos| per step {[float(f'{v:.3e}') for v in d]} m")
    if "tape.contact.active" in g:
        split = (buf["contact"].active.numpy()
                 != g["tape.contact.active"]).sum(axis=1)
        print(f"  active flags differing between the two tapes' contact "
              f"sets, steps 1..2: {split.tolist()}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("name")
    ap.add_argument("--reference", action="store_true",
                    help="also build the JAX package's contact sets on the "
                         "same positions (needs jax)")
    ap.add_argument("--golden", action="store_true",
                    help="also run the rollout test's 2 steps and compare "
                         "them with tests/data/scenes_golden.npz")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.reference:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        rounding_check()
    sc = registry.make_scene(args.name, solver="auto")
    spec, s0, params = sc.to("cpu")
    print(f"{args.name}: NV {spec.NV}, {spec.contact.capacity} contact "
          f"slots, eps_contact {spec.eps_contact}")
    port0 = port_sets(spec, params, s0.pos, s0.proj_flag, s0.proj_dir)
    report_ties("state0", spec, port0[0], port0[4], port0[5])
    if args.reference:
        reference_split(args.name, "state0", s0.pos, s0.proj_flag,
                        s0.proj_dir, port0)
    if args.golden:
        golden_split(args.name, sc, spec, s0, params)
    acts = tuple(torch.as_tensor(a) for a in smoke_actions(sc.n_part))
    s1, _ = stepper.rollout(spec, params, s0, acts)
    port1 = port_sets(spec, params, s1.pos, s1.proj_flag, s1.proj_dir)
    report_ties("after step 1", spec, port1[0], port1[4], port1[5])
    if args.reference:
        reference_split(args.name, "after step 1 (port's positions)", s1.pos,
                        s1.proj_flag, s1.proj_dir, port1)


if __name__ == "__main__":
    main()
