"""The port's iterative paths without a DIA plan, against the JAX package's,
in f64 on the CPU: the plain and pull operators and the block diagonal,
CG on the pull operator, the element-wise |H| blocks, MINRES, the folding
scene's whole `solver="cg"` rollout and backward, and the specs that every
other task scene builds under `solver="cg"`.

  * operators: `folding.make(table_n=4)` (no DIA plan: the cloth is too
    narrow, so CG takes the pull operator) and `bench_scene.make(cloth_N=12)`
    (a DIA plan; its plain scatter operator `hvp` and `diag_blocks`), at the
    initial state jittered by 1e-4 m (numpy seed 0), as
    tests/test_assembly.py builds them; both packages apply their own
    operator to the same element blocks (the port's, whose parity
    tests/test_torch_elements.py holds).
  * MINRES: `folding.make(table_n=5)` at the established-contact state of
    tests/test_assembly.py (the pad pressed 0.6 mm a step for 3 steps), on
    the true Hessian, against JAX's solve_minres and the dense solve.
  * the rollout: `folding.make(table_n=4, solver="cg", max_newton_iter=5)`,
    T=2, the pad pressed 0.6 mm a step (it reaches the cloth: the gripper
    gradient is not zero), against the JAX run kept in
    tests/data/cg_scenes_golden.npz.

The other task scenes under `solver="cg"` build DIA plans of 21 to 351
offsets on 1024 or 2048 rows, and their CG solves run to hundreds of
iterations: a CPU rollout of one of them takes minutes a step, so here
only their specs are held against JAX, leaf by leaf, and their runs are
held against the golden file on the card (chip_smoke.py [cg-scenes]).

The golden file holds, for every task scene under `solver="cg"` in f64 at
T=2 and `max_newton_iter=5` (each pad 0.2 mm down a step; folding as
above): the positions, the default seed's gripper gradient (and the
system-ID parameter's on the scenes that have one), the reward, the CG
iterations of each step's first Newton solve, the adjoint solve's
iterations per backward step, and for the scenes whose contact ties the
packages decide differently (ROADMAP §3) the JAX tape with its contact
sets. Regenerate it (after a deliberate change of the reference; about
half an hour of JAX on the CPU):

    PYTHONPATH=. python tests/test_torch_solver_paths.py
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.engine import elements as jelements
from thinshelllab_tpu.engine import solver as jsolver
from thinshelllab_tpu.engine import stepper as jstepper
from thinshelllab_tpu.scenes import bench_scene as jbench
from thinshelllab_tpu.scenes import folding as jfolding
from thinshelllab_tpu.scenes import registry as jregistry
from thinshelllab_torch.core.convert import golden_grad_errors
from thinshelllab_torch.engine import adjoint, elements, plans, solver, stepper
from thinshelllab_torch.scenes import bench_scene, folding, registry
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)
from test_torch_scenes import _assert_close

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "cg_scenes_golden.npz")
# every task scene of the registry; folding runs at table_n=4 in the golden
SCENES = ["folding", "lifting", "sliding", "card", "pick", "forming",
          "balancing", "bouncing", "interact"]
DIA_SCENES = SCENES[1:]
# the scenes whose contact ties the packages decide differently (ROADMAP
# §3, tests/test_torch_scene_rollouts.py): the golden keeps their tape
TIES = ("sliding", "card", "pick", "interact")
T, MAX_NEWTON = 2, 5
SCENE_DZ, FOLD_DZ, FOLD_TABLE_N = -2e-4, -6e-4, 4
# one operator apply on the same element blocks: 1e-11 of max |H|, as
# tests/test_assembly.py holds the assemblies against the dense Hessian
OP_ATOL = 1e-11
# a solve of the same operator in another summation order
SOLVE_RTOL = 1e-10
# the rollout (Newton to newton_tol 1e-7 on both sides) and the backward
POS_ATOL, GRAD_RTOL = 1e-9, 1e-7
# the iterations of a CG or MINRES solve of a slowly converging system
# whose inputs differ by rounding (1e-13 m on the rollout): the last
# iteration's residual can fall on either side of the exit test
ITER_SLACK = 2


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _port_system(spec, s0, params, spd=True):
    """The port's element blocks at the jittered initial state."""
    rng = np.random.default_rng(0)
    pos = s0.pos + 1e-4 * torch.as_tensor(rng.normal(size=s0.pos.shape))
    contact, _, _ = stepper.build_contacts(spec, params, pos, pos,
                                           s0.proj_flag, s0.proj_dir)
    return elements.all_groups(spec, params, pos, s0.ref_angle, contact,
                               with_hess=True, spd=spd)


def _jax_groups(groups):
    return {"idx": jnp.asarray(groups["idx"].numpy().astype(np.int32)),
            "H": jnp.asarray(groups["H"].numpy())}


@pytest.fixture(scope="module", params=["folding4", "bench12"])
def system(request):
    """(name, JAX spec, JAX-side blocks, port spec, port blocks, the true
    Hessian's port blocks)."""
    if request.param == "folding4":
        jsc = jfolding.make(table_n=4, dtype=jnp.float64, solver="cg")
        sc = folding.make(table_n=4, dtype=torch.float64, solver="cg")
    else:
        jsc = jbench.make(cloth_N=12, dtype=jnp.float64, solver="cg")
        sc = bench_scene.make(cloth_N=12, dtype=torch.float64, solver="cg")
    spec, s0, params = sc.to("cpu")
    groups = _port_system(spec, s0, params)
    true = _port_system(spec, s0, params, spd=False)
    return (request.param, jsc.spec, _jax_groups(groups), spec, groups,
            true)


def test_plain_and_pull_operators_match_jax(system):
    """hvp, hvp_pull (folding: no DIA plan) and diag_blocks on the same
    element blocks, within 1e-11 of max |H|."""
    name, jspec, jgroups, spec, groups, _true = system
    assert (spec.dia is None) == (name == "folding4")
    x = np.random.default_rng(1).normal(size=(spec.NV, 3))
    x[np.asarray(jspec.frozen)] = 0.0
    scale = float(np.abs(np.asarray(
        jelements.dense_hessian(jspec, jgroups))).max()) + 1.0
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    got = elements.hvp(spec, groups, xt).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jelements.hvp(jspec, jgroups, xj)), rtol=0, atol=OP_ATOL * scale)
    got = elements.diag_blocks(spec, groups).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jelements.diag_blocks(jspec, jgroups)), rtol=0, atol=OP_ATOL * scale)
    if spec.dia is None:
        nbr = elements.gather_neighbor_blocks(spec, groups, torch.float64)
        jnbr = jelements.gather_neighbor_blocks(jspec, jgroups, jnp.float64)
        got = elements.hvp_pull(spec, nbr, groups, xt).numpy()
        want = np.asarray(jelements.hvp_pull(jspec, jnbr, jgroups, xj))
        np.testing.assert_allclose(got, want, rtol=0, atol=OP_ATOL * scale)
        # the pull operator is the plain one
        np.testing.assert_allclose(got, elements.hvp(spec, groups, xt),
                                   rtol=0, atol=OP_ATOL * scale)
    np.testing.assert_array_equal(elements._padded_static_idx(jspec),
                                  jelements._padded_static_idx(jspec))


@pytest.mark.parametrize("system", ["folding4"], indirect=True)
def test_pull_cg_matches_jax(system):
    """solve_cg without a DIA plan (one block-Jacobi sweep, the pull
    operator) against JAX's solve_cg_prepared: the same iterations (within
    ITER_SLACK), the solution within 1e-10; and warm-started from a seeded
    x0."""
    name, jspec, jgroups, spec, groups, _true = system
    F = np.random.default_rng(2).normal(size=(spec.NV, 3))
    F[np.asarray(jspec.frozen)] = 0.0
    x0 = np.random.default_rng(4).normal(size=(spec.NV, 3)) * 1e-3
    jst = jsolver.prepare_solver_state(jspec, jgroups, jnp.float64)
    for warm in (None, x0):
        want, jit_ = jsolver.solve_cg_prepared(
            jspec, jst, jnp.asarray(F), return_iters=True,
            x0=None if warm is None else jnp.asarray(warm))
        got, it = solver.solve_cg(
            spec, groups, torch.as_tensor(F), return_iters=True,
            x0=None if warm is None else torch.as_tensor(warm))
        assert abs(it - int(jit_)) <= ITER_SLACK and it > 0, (it, jit_)
        assert _rel(got, want) < SOLVE_RTOL


def test_abs_element_blocks_match_jax(system):
    """|H_e| of the true (unprojected) element blocks, within 1e-12 of the
    largest entry (12x12 eigh on both sides, f64)."""
    H = system[-1]["H"]
    got = solver._abs_element_blocks(H)
    want = jsolver._abs_element_blocks(jnp.asarray(H.numpy()))
    assert _rel(got, want) < 1e-12


@pytest.fixture(scope="module")
def minres_system():
    """folding table_n=5 at the established-contact state of
    tests/test_assembly.py::test_minres_matches_dense_on_true_hessian:
    the port's own rollout (dense, 3 steps of 0.6 mm down) and the true
    Hessian's element blocks at its end state."""
    sc = folding.make(table_n=5, max_newton_iter=20, dtype=torch.float64)
    spec, s0, params = sc.to("cpu")
    dpos = torch.zeros((3, sc.n_part, 3), dtype=torch.float64)
    dpos[:, :, 2] = -0.0006
    st, _ = stepper.rollout(spec, params, s0,
                            (dpos, torch.zeros_like(dpos),
                             torch.zeros((3, sc.n_part),
                                         dtype=torch.float64)))
    contact, _, _ = stepper.build_contacts(spec, params, st.pos, st.pos,
                                           st.proj_flag, st.proj_dir)
    groups = elements.all_groups(spec, params, st.pos, st.ref_angle, contact,
                                 with_hess=True, spd=False)
    assert bool(contact.active.any())
    jspec = jfolding.make(table_n=5, max_newton_iter=20).spec
    g = np.random.default_rng(3).normal(0, 1, (spec.NV, 3))
    return jspec, _jax_groups(groups), spec, groups, g


def test_minres_matches_jax_and_dense(minres_system):
    """solve_minres (the MINRES adjoint of a scene without a DIA plan:
    |D|^-1 of the |H| operator) against JAX's solve_minres (the same
    iterations within ITER_SLACK, the solution within 1e-10) and against the dense solve on the unfrozen
    DOFs (1e-6, tests/test_assembly.py's bound); solve_adjoint takes it on
    a cg spec, and a warm start converges to the same point."""
    jspec, jgroups, spec, groups, g = minres_system
    jspec = jspec.replace(solver="cg")
    spec = spec.replace(solver="cg")
    want, jit_ = jax.jit(lambda gr, b: jsolver.solve_minres(
        jspec, gr, b, return_iters=True))(jgroups, jnp.asarray(g))
    got, it = solver.solve_adjoint(spec, groups, torch.as_tensor(g),
                                   return_iters=True)
    assert abs(it - int(jit_)) <= ITER_SLACK, (it, jit_)
    assert 0 < it < spec.cg_max_iter
    assert _rel(got, want) < SOLVE_RTOL
    unf = ~np.asarray(jspec.frozen)
    zd = solver.solve_dense(spec, groups, torch.as_tensor(g)).numpy()[unf]
    err = np.linalg.norm(got.numpy()[unf] - zd) / np.linalg.norm(zd)
    assert err < 1e-6, err
    warm, _ = solver.solve_minres(spec, groups, torch.as_tensor(g),
                                  return_iters=True, x0=0.5 * got)
    err = np.linalg.norm(warm.numpy()[unf] - zd) / np.linalg.norm(zd)
    assert err < 1e-6, err


def _golden(name):
    z = np.load(GOLDEN)
    pre = name + "."
    return {k[len(pre):]: z[k] for k in z.files if k.startswith(pre)}


def scene_actions(name, n_part, steps=T):
    dpos = np.zeros((steps, n_part, 3))
    dpos[:, :, 2] = FOLD_DZ if name == "folding" else SCENE_DZ
    return dpos, np.zeros((steps, n_part, 3)), np.zeros((steps, n_part))


def scene_kwargs(name):
    kw = dict(solver="cg", max_newton_iter=MAX_NEWTON)
    if name == "folding":
        kw["table_n"] = FOLD_TABLE_N
    return kw


def first_cg_per_step(stats):
    """The CG iterations of each step's first Newton solve, from a rollout's
    solver stats."""
    out, i = [], 0
    for n in stats["newton_per_step"]:
        out.append(stats["cg_per_newton"][i])
        i += n
    return out


def test_folding_cg_rollout_and_backward_match_jax():
    """folding table_n=4 under solver="cg" (pull-path CG forward, MINRES
    backward) against the JAX run: positions within 1e-9 m, the gripper
    gradient within 1e-7 of its largest entry, the same CG iterations in
    each step's first Newton solve and the same MINRES iterations."""
    g = _golden("folding")
    sc = registry.make_scene("folding", dtype=torch.float64,
                             **scene_kwargs("folding"))
    spec, s0, params = sc.to("cpu")
    assert spec.dia is None and spec.hvp_slots is not None
    stats = {}
    acts = tuple(torch.as_tensor(a)
                 for a in scene_actions("folding", sc.n_part))
    _, buf = stepper.simulate(spec, params, s0, acts, stats=stats,
                              save_contacts=True)
    np.testing.assert_allclose(buf["pos"].numpy(), g["pos"], rtol=0,
                               atol=POS_ATOL)
    # debug_iters puts the iterations in place of pos_grad0 only
    res = adjoint.backward(spec, params, buf, *sc.seed_loss(buf),
                           debug_iters=True)
    for got, want in ((first_cg_per_step(stats), g["cg_first"]),
                      (res.pos_grad0, g["adj_iters"])):
        assert np.abs(np.asarray(got) - want).max() <= ITER_SLACK, (got, want)
    gg, _pg, _sys = golden_grad_errors(res, g, sc.sys_param)
    assert float(np.abs(g["gripper_grad"]).max()) > 0
    assert gg < GRAD_RTOL, gg


@pytest.mark.parametrize("name", DIA_SCENES)
def test_cg_scene_spec_matches_jax(name):
    """Each DIA task scene's solver="cg" spec (its DIA plan, leftover hvp
    slots and every other leaf) against the JAX package's, with no
    simulation; and the plan's shape is the golden run's."""
    sc = registry.make_scene(name, solver="cg")
    jsc = jregistry.make_scene(name, solver="cg")
    _assert_close(sc.spec, jsc.spec)
    plan = sc.spec.dia
    assert plan is not None and sc.spec.solver == "cg"
    assert plan.NVp in (1024, 2048)
    assert 21 <= len(plan.offsets) <= 351
    g = _golden(name)
    assert g["pos"].shape == (T + 1, sc.spec.NV, 3)
    assert int(g["n_off"]) == len(plan.offsets)


@pytest.mark.parametrize("name", ["lifting", "forming"])
def test_contact_matvec_without_mm_pairs(name):
    """The contact matvec a scene on the card applies (no 'mm' pair:
    `plans.contact_static_split(mm=False)`, as `elements.device_consts`
    builds it for a CUDA scene) against the CPU's one-hot selection
    matmuls, in both layouts, on random contact blocks. Lifting's split
    has only 'mm' pairs (none is left without them), forming's also a
    frozen-source diagonal pair."""
    sc = registry.make_scene(name, solver="cg")
    spec, s0, params = sc.to("cpu")
    assert spec.dev.contact_split[1], "the CPU spec has 'mm' pairs"
    spec_g = spec.replace(dev=dataclasses.replace(
        spec.dev, contact_split=plans.contact_static_split(sc.spec,
                                                           mm=False)))
    groups = _port_system(spec, s0, params)
    ns = elements.static_block_count(spec)
    rng = np.random.default_rng(1)
    H = groups["H"].clone()
    # the pairs' slots get random blocks; the capacity's padding slots past
    # the last pair stay zero, as every inactive slot's blocks are
    for (cs, cnt, *_rest) in spec.contact.pair_desc:
        sl = slice(ns + cs, ns + cs + cnt)
        H[sl] = torch.as_tensor(rng.normal(size=H[sl].shape))
    groups = {"idx": groups["idx"], "H": H}
    x = torch.as_tensor(rng.normal(size=(spec.NV, 3)))
    f64 = torch.float64
    out = []
    for sp in (spec, spec_g):
        st = solver.prepare_solver_state(sp, groups, f64)
        fused = {k: st[k] for k in ("idx", "H", "Dcon", "idx_con", "H_con",
                                    "mm_S", "mm_H") if k in st}
        DconT = (elements.blocks_to_t33(sp, st["Dcon"], f64)
                 if "Dcon" in st else None)
        unf2, _m2 = elements.t2_consts(sp, f64)
        out.append((solver._ops_from_state(sp, st)(x),
                    elements.hvp_dia_contact_T(sp, fused,
                                               elements.to_t2(sp, x), unf2,
                                               DconT)))
    assert "mm_S" not in fused
    for got, want in zip(out[1], out[0]):
        assert _rel(got, want.numpy()) <= 1e-13


# ------------------------------------------------------------ the golden


def _first_cg_jax(spec, params, s0, acts):
    """The CG iterations of each step's first Newton solve of the JAX
    package, step by step from its own states (the Newton loop is a
    while_loop that does not report them)."""
    from thinshelllab_tpu.engine import gripper as jgripper

    def first(state, action):
        dp, dr, dd = (jnp.asarray(a, spec.dtype) for a in action)
        gs = jgripper.gripper_step(spec, state.gripper, dp, dr, dd)
        pos = jgripper.write_bound_vertices(spec, state.pos, gs)
        contact, _, _ = jstepper.build_contacts(
            spec, params, pos, pos, state.proj_flag, state.proj_dir)
        md = jnp.asarray(spec.mass)
        x_hat = pos + state.vel * spec.dt + (
            jnp.asarray(spec.gravity)
            + jnp.asarray(spec.ext_force) / md[:, None]) * spec.dt**2
        start = jnp.where(jnp.asarray(spec.frozen), pos, x_hat)
        groups = jelements.all_groups(spec, params, start, state.ref_angle,
                                      contact, with_hess=True, spd=True)
        F = jelements.assemble_residual(spec, groups, start, pos, state.vel)
        st = jsolver.prepare_solver_state(spec, groups, F.dtype)
        return jsolver.solve_cg_prepared(spec, st, F, return_iters=True)[1]

    first = jax.jit(first)
    step = jax.jit(lambda s, a: jstepper.time_step(spec, params, s, a)[0])
    its, st = [], s0
    for t in range(acts[0].shape[0]):
        a = tuple(x[t] for x in acts)
        its.append(int(first(st, a)))
        st = step(st, a)
    return np.asarray(its)


def _reference(name):
    """The JAX package's solver="cg" run of one scene (the golden file's
    entries)."""
    from thinshelllab_tpu.engine import adjoint as jadjoint
    from thinshelllab_tpu.scenes import balancing as jbalancing
    from thinshelllab_tpu.utils import checkpoint as jcheckpoint

    sc = jregistry.make_scene(name, **scene_kwargs(name))
    if name == "balancing":
        st = jcheckpoint.load_state(jbalancing.bundled_state_path())
        sc.state0 = jax.tree.map(
            lambda a, b: np.asarray(a, np.asarray(b).dtype), st, sc.state0)
    spec, params = sc.spec, sc.params
    s0 = jax.tree.map(jnp.asarray, sc.state0)
    acts = tuple(jnp.asarray(a) for a in scene_actions(name, sc.n_part))
    wpg = sc.sys_param is not None

    def run(s, a):
        _, buf = jstepper.simulate(spec, params, s, a, save_contacts=True)
        seeds = sc.seed_loss(buf)
        res = jadjoint.backward(spec, params, buf, *seeds,
                                with_param_grad=wpg)
        its = jadjoint.backward(spec, params, buf, *seeds,
                                debug_iters=True).pos_grad0
        return buf, res, its

    buf, res, its = jax.jit(run)(s0, acts)
    out = {"pos": np.asarray(buf["pos"]),
           "gripper_grad": np.asarray(res.gripper_grad),
           "reward": np.asarray(sc.reward(buf)),
           "adj_iters": np.asarray(its),
           "cg_first": _first_cg_jax(spec, params, s0, acts),
           "n_off": np.asarray(0 if spec.dia is None
                               else len(spec.dia.offsets))}
    if wpg:
        for f in dataclasses.fields(res.param_grad):
            out["param_grad." + f.name] = np.asarray(
                getattr(res.param_grad, f.name))
    if name in TIES:
        for k, v in buf.items():
            if k == "contact":
                for f in dataclasses.fields(v):
                    out["tape.contact." + f.name] = np.asarray(
                        getattr(v, f.name))
            else:
                out["tape." + k] = np.asarray(v)
    return out


def write_golden(names=SCENES):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {}
    for name in names:
        for k, v in _reference(name).items():
            out[f"{name}.{k}"] = v
        print(name, "done", out[f"{name}.cg_first"],
              out[f"{name}.adj_iters"], flush=True)
    return out


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1:  # one part of the file: the named scenes
        np.savez_compressed(sys.argv[1], **write_golden(sys.argv[2:]))
    else:
        np.savez_compressed(GOLDEN, **write_golden())
