"""The port's collision, gripper and element/operator layers against the
JAX package's, on the small bench scene in f64 on the CPU.

Two states: the scene's initial one with every vertex moved by 1e-4 m
of noise (so that the elements carry forces well above rounding), and the
golden rollout's last (tests/data/bench8_golden.npz: the cloth pressed
under the pad, with active contacts). Integer tables (projection flags,
sides, triangles, element indices) must be equal; floats agree to rtol
1e-10 (the same arithmetic, sums in another order).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.engine import elements as jel
from thinshelllab_tpu.engine import gripper as jgrip
from thinshelllab_tpu.engine import solver as jsol
from thinshelllab_tpu.ops import collision as jcol
from thinshelllab_tpu.scenes import bench_scene as jbench
from thinshelllab_torch.engine import elements as el
from thinshelllab_torch.engine import gripper as grip
from thinshelllab_torch.engine import solver as sol
from thinshelllab_torch.engine import stepper
from thinshelllab_torch.ops import collision as col
from thinshelllab_torch.scenes import bench_scene
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "bench8_golden.npz")
CFG = dict(cloth_N=8, table_n=4, solver="cg", hess_refresh=8,
           max_newton_iter=4)
RTOL = 1e-10
ALPHAS = (1.0, 0.5, 0.125, 0.0)


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def scenes():
    jsc = jbench.make(dtype=jnp.float64, **CFG)
    tsc = bench_scene.make(dtype=torch.float64, **CFG)
    return jsc, tsc.to("cpu")


def _states(jsc):
    """(pos, prev_pos, vel, proj_flag, proj_dir) of the two test states."""
    s0 = jsc.state0
    g = np.load(GOLDEN)
    moved = s0.pos + 1e-4 * np.random.default_rng(0).normal(
        size=s0.pos.shape)
    first = (moved, moved, np.zeros_like(moved), s0.proj_flag, s0.proj_dir)
    pressed = g["pos"][-1]
    vel = (g["pos"][-1] - g["pos"][-2]) / jsc.spec.dt
    # the flags latched by the rollout up to that state
    flag = np.ones_like(s0.proj_flag)
    return {"perturbed": first,
            "pressed": (pressed, pressed, vel, flag, np.ones_like(flag))}


@pytest.fixture(scope="module", params=["perturbed", "pressed"])
def case(request, scenes):
    """Everything both packages compute at one state."""
    jsc, (spec, _s0, params) = scenes
    J, jp = jsc.spec, jsc.params
    pos, prev, vel, flag, dirs = _states(jsc)[request.param]
    rng = np.random.default_rng(3)
    p = 1e-4 * rng.normal(size=pos.shape)
    x = rng.normal(size=pos.shape) * ~J.frozen
    ref = jsc.state0.ref_angle

    @jax.jit
    def reference(pos, prev, vel, flag, dirs, p, x):
        vn = jcol.vertex_normals(pos, jnp.asarray(J.faces), J.NV)
        pf, pd, tri, w = jcol.projection_query(J, pos, vn, flag, dirs)
        c = jcol.contact_analysis(J, jp.mu_pairs, pos, prev, pf, pd, tri, w)
        groups = jel.all_groups(J, jp, pos, ref, c, with_hess=True, spd=True)
        F = jel.assemble_residual(J, groups, pos, prev, vel)
        st = jsol.prepare_solver_state(J, groups, jnp.float64)
        unf2, m2 = jel.t2_consts(J, jnp.float64)
        gT = {k: st[k] for k in ("idx", "H", "Dcon", "idx_con", "H_con",
                                 "mm_S", "mm_H") if k in st}
        DconT = jel.blocks_to_t33(J, st["Dcon"], jnp.float64)
        x2 = jel.to_t2(J, x)
        Ax = (jel.hvp_dia_static_T(J, st["dia"], st.get("nbr"), x2, unf2, m2)
              + jel.hvp_dia_contact_T(J, gT, x2, unf2, DconT))
        soups = jel.gather_soups(J, c, pos)
        EF = jel.linesearch_ef_fn(J, jp, pos, p, prev, vel, ref, c, soups,
                                  jel.gather_soups(J, c, p, direction=True))
        fg = jel.force_groups_from_soups(J, jp, soups, ref, c)
        cg, iters = jsol._solve_cg_prepared_T(J, st, F, return_iters=True,
                                              x0=p)
        return dict(
            vn=vn, proj=(pf, pd, tri, w), contact=c, groups=groups, F=F,
            F_soups=jel.assemble_residual(J, fg, pos, prev, vel),
            st={k: st[k] for k in ("dia", "D", "Dc", "nbr", "Dcon", "mm_S",
                                   "mm_H")},
            Ax=Ax, EF=[EF(a) for a in ALPHAS],
            E=[jel.total_energy(J, jp, pos - a * p, prev, vel, ref, c)
               for a in ALPHAS],
            cg=cg, cg_iters=iters)

    want = reference(*(jnp.asarray(a) for a in (pos, prev, vel, flag, dirs,
                                                 p, x)))
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in
         dict(pos=pos, prev=prev, vel=vel, flag=flag, dirs=dirs, p=p, x=x,
              ref=ref).items()}
    t["state"] = request.param
    return spec, params, t, jax.tree.map(np.asarray, want)


def test_collision_matches_jax(case):
    spec, params, t, want = case
    vn = col.vertex_normals(t["pos"], spec.faces, spec.NV)
    _close(vn, want["vn"])
    pf, pd, tri, w = col.projection_query(spec, t["pos"], vn, t["flag"],
                                          t["dirs"])
    for got, ref in zip((pf, pd, tri), want["proj"][:3]):
        _equal(got, ref)
    _close(w, want["proj"][3])
    c = col.contact_analysis(spec, params.mu_pairs, t["pos"], t["prev"], pf,
                             pd, tri, w)
    jc = want["contact"]
    _equal(c.active, jc.active)
    _equal(c.idx, jc.idx)
    for f in ("w", "n", "k", "mu", "dx0", "T"):
        _close(getattr(c, f), getattr(jc, f))


def test_build_contacts_matches_jax(case):
    spec, params, t, want = case
    c, flag, dirs = stepper.build_contacts(spec, params, t["pos"], t["prev"],
                                           t["flag"], t["dirs"])
    _equal(c.active, want["contact"].active)
    _equal(flag, want["proj"][0])
    _equal(dirs, want["proj"][1])
    if t["state"] == "pressed":  # the pad has reached the cloth
        assert int(c.active.sum()) > 0


def _contact(spec, params, t):
    return stepper.build_contacts(spec, params, t["pos"], t["prev"],
                                  t["flag"], t["dirs"])[0]


def test_groups_and_residual_match_jax(case):
    spec, params, t, want = case
    c = _contact(spec, params, t)
    groups = el.all_groups(spec, params, t["pos"], t["ref"], c)
    _equal(groups["idx"], want["groups"]["idx"])
    _close(groups["g"], want["groups"]["g"])
    _close(groups["H"], want["groups"]["H"])
    F = el.assemble_residual(spec, groups, t["pos"], t["prev"], t["vel"])
    _close(F, want["F"])
    soups = el.gather_soups(spec, c, t["pos"])
    fg = el.force_groups_from_soups(spec, params, soups, t["ref"], c)
    _close(el.assemble_residual(spec, fg, t["pos"], t["prev"], t["vel"]),
           want["F_soups"])


def test_operator_and_cg_match_jax(case):
    spec, params, t, want = case
    c = _contact(spec, params, t)
    groups = el.all_groups(spec, params, t["pos"], t["ref"], c)
    st = sol.prepare_solver_state(spec, groups, torch.float64)
    for k in ("dia", "D", "Dc", "nbr", "Dcon"):
        _close(st[k], want["st"][k])
    for k in ("mm_S", "mm_H"):
        assert len(st[k]) == len(want["st"][k]) > 0
        for a, b in zip(st[k], want["st"][k]):
            _close(a, b)
    unf2, m2 = spec.dev.unf2, spec.dev.m2
    gT = {k: st[k] for k in ("idx", "H", "Dcon", "idx_con", "H_con", "mm_S",
                             "mm_H") if k in st}
    DconT = el.blocks_to_t33(spec, st["Dcon"], torch.float64)
    x2 = el.to_t2(spec, t["x"])
    Ax = (el.hvp_dia_static_T(spec, st["dia"], st.get("nbr"), x2, unf2, m2)
          + el.hvp_dia_contact_T(spec, gT, x2, unf2, DconT))
    _close(Ax, want["Ax"])
    F = el.assemble_residual(spec, groups, t["pos"], t["prev"], t["vel"])
    x, iters = sol._solve_cg_prepared_T(spec, st, F, return_iters=True,
                                        x0=t["p"])
    assert iters == int(want["cg_iters"]) > 0
    _close(x, want["cg"], rtol=1e-8)


def test_linesearch_and_energy_match_jax(case):
    spec, params, t, want = case
    c = _contact(spec, params, t)
    soups = el.gather_soups(spec, c, t["pos"])
    EF = el.linesearch_ef_fn(spec, params, t["pos"], t["p"], t["prev"],
                             t["vel"], t["ref"], c, soups,
                             el.gather_soups(spec, c, t["p"], direction=True))
    for a, (wE, wg), wE2 in zip(ALPHAS, want["EF"], want["E"]):
        E, g = EF(a)
        _close(E, wE)
        _close(g, wg)
        _close(el.total_energy(spec, params, t["pos"] - a * t["p"], t["prev"],
                               t["vel"], t["ref"], c), wE2)


def test_gripper_matches_jax(scenes):
    jsc, (spec, s0, _params) = scenes
    rng = np.random.default_rng(4)
    act = (rng.normal(0, 1e-3, (1, 3)), rng.normal(0, 1e-2, (1, 3)),
           rng.normal(0, 1e-3, (1,)))
    gs_j = jgrip.gripper_step(jsc.spec, jax.tree.map(jnp.asarray,
                                                     jsc.state0.gripper),
                              *(jnp.asarray(a) for a in act))
    pos_j = jgrip.write_bound_vertices(jsc.spec, jnp.asarray(jsc.state0.pos),
                                       gs_j)
    gs = grip.gripper_step(spec, s0.gripper,
                           *(torch.as_tensor(a) for a in act))
    for f in ("pos", "rot", "dist", "pad_local"):
        _close(getattr(gs, f), getattr(gs_j, f))
    _close(grip.pad_world_positions(spec, gs),
           jgrip.pad_world_positions(jsc.spec, gs_j))
    _close(grip.write_bound_vertices(spec, s0.pos, gs), pos_j)
