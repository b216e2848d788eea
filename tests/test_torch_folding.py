"""The port's folding scene against the JAX package's, in f64 on the CPU:
the built state (the pre-curl's plastic rest angles), the eigh projection,
the dense assembly (Hessian and scatter residual), the energy-only line
search, the dense solve, the full-Newton rollout with plastic rest-angle
updates, and the dense-solve backward.

The scene is `folding.make(table_n=4, max_newton_iter=30)`: the published
cloth, pad and settings on a 4x4x2 table (372 vertices, 1116 DOF, the
dense solver). The pad follows a seeded 4-step action table (0.3 mm down
a step plus seeded sideways moves and turns). On this table no query
vertex sits at a contact threshold, so both packages take the same
contacts without a jitter.

The JAX package's outputs (its rollout, backward, contact set and the
evaluations at the perturbed state) are in
tests/data/folding_reference_golden.npz. Regenerate it (after a deliberate
change of the reference):
    OPENBLAS_NUM_THREADS=1 PYTHONPATH=. python tests/test_torch_folding.py
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.engine import adjoint as jadjoint
from thinshelllab_tpu.engine import elements as jelements
from thinshelllab_tpu.engine import solver as jsolver
from thinshelllab_tpu.engine import stepper as jstepper
from thinshelllab_tpu.ops import spd as jspd
from thinshelllab_tpu.scenes import folding as jfolding
from thinshelllab_torch.core.convert import from_reference
from thinshelllab_torch.core.spec import ContactSet
from thinshelllab_torch.engine import adjoint, elements, solver, stepper
from thinshelllab_torch.ops import spd
from thinshelllab_torch.scenes import folding
import _golden
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                         "folding_reference_golden.npz")
CFG = dict(table_n=4, max_newton_iter=30)
N_STEPS = 4  # a waypoint table of T=5 rows
ALPHAS = (0.0, 0.5, 1.0)
# one evaluation (element blocks, assembly, energy): the same arithmetic
# with sums in another order, max |port - JAX| / max |JAX|
EVAL_RTOL = 1e-10
# the rollout: Newton to newton_tol 1e-7 (|p|_inf / dt) in both packages
POS_ATOL = 1e-9  # metres
REF_ATOL = 1e-10  # radians
# the backward: dense solves of the true Hessian along the tape
GRAD_RTOL = 1e-7


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _actions():
    rng = np.random.default_rng(0)
    dpos = rng.normal(0.0, 1e-4, size=(N_STEPS, 1, 3))
    dpos[:, 0, 2] = -3e-4
    drot = rng.normal(0.0, 2e-3, size=(N_STEPS, 1, 3))
    return dpos, drot, np.zeros((N_STEPS, 1))


def _perturbations(spec):
    """A perturbed state and a search direction on the unfrozen DOFs."""
    rng = np.random.default_rng(1)
    unf = ~np.asarray(spec.frozen)
    return (rng.normal(0.0, 1e-4, size=(spec.NV, 3)) * unf,
            rng.normal(0.0, 1e-4, size=(spec.NV, 3)) * unf)


@pytest.fixture(scope="module")
def scenes():
    return jfolding.make(**CFG), folding.make(**CFG)


def _reference():
    """Every JAX quantity of the file, from one jitted program, as REFERENCE
    stores them: the buffers, the backward's two gradients, the contact set
    and the evaluations at the perturbed state."""
    jsc = jfolding.make(**CFG)
    spec, params = jsc.spec, jsc.params
    s0 = jax.tree.map(jnp.asarray, jsc.state0)

    def run(s0, acts, pert, pdir):
        _, buf = jstepper.simulate(spec, params, s0, acts)
        res = jadjoint.backward(spec, params, buf, *jsc.seed_loss(buf))
        pos = s0.pos + pert
        contact, _, _ = jstepper.build_contacts(
            spec, params, pos, s0.pos, s0.proj_flag, s0.proj_dir)
        groups = jelements.all_groups(spec, params, pos, s0.ref_angle,
                                      contact, with_hess=True, spd=True)
        F = jelements.assemble_residual(spec, groups, pos, s0.pos, s0.vel)
        E_of = jelements.linesearch_energy_fn(spec, params, pos, pdir,
                                              s0.pos, s0.vel, s0.ref_angle,
                                              contact)
        evals = dict(H=jelements.dense_hessian(spec, groups), F=F,
                     p=jsolver.solve_dense(spec, groups, F),
                     E=jnp.stack([E_of(a) for a in ALPHAS]),
                     E_tot=jnp.stack([jelements.total_energy(
                         spec, params, pos - a * pdir, s0.pos, s0.vel,
                         s0.ref_angle, contact) for a in ALPHAS]))
        return buf, res, contact, evals

    pert, pdir = _perturbations(spec)
    buf, res, contact, evals = jax.jit(run)(
        s0, tuple(jnp.asarray(a) for a in _actions()), jnp.asarray(pert),
        jnp.asarray(pdir))
    res = dict(gripper_grad=res.gripper_grad, pos_grad0=res.pos_grad0)
    return jax.tree.map(np.asarray, dict(buf=buf, res=res, contact=contact,
                                         evals=evals))


def assert_reference_entry(key, got, want):
    """One entry of REFERENCE against its recomputed value, at the
    tolerance the tests hold the port to it."""
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=key)
    elif key == "buf.ref_angle":
        np.testing.assert_allclose(got, want, rtol=0, atol=REF_ATOL,
                                   err_msg=key)
    elif key.startswith("buf."):
        np.testing.assert_allclose(got, want, rtol=0, atol=POS_ATOL,
                                   err_msg=key)
    elif key == "evals.p":
        assert _rel(got, want) < 1e-9, key
    else:
        # the gradients at GRAD_RTOL; the evaluations, and the contact set
        # they read, at EVAL_RTOL
        tol = GRAD_RTOL if key.startswith("res.") else EVAL_RTOL
        assert _rel(got, want) < tol, key


@pytest.fixture(scope="module")
def ref():
    """REFERENCE as (buffers, backward, contact set, evaluations)."""
    g = _golden.load(REFERENCE)
    return (g["buf"], types.SimpleNamespace(**g["res"]),
            ContactSet(**g["contact"]), g["evals"])


@pytest.fixture(scope="module")
def port(scenes, ref):
    """The port's scene on the CPU and its own rollout and backward."""
    sc = scenes[1]
    spec, s0, params = sc.to("cpu")
    stats = {}
    _, buf = stepper.simulate(spec, params, s0,
                              tuple(torch.as_tensor(a) for a in _actions()),
                              stats=stats)
    res = adjoint.backward(spec, params, buf, *sc.seed_loss(buf))
    return spec, s0, params, buf, res, stats


def test_state0_matches_jax(scenes):
    """The built state, the pre-curl's plastic rest angles included."""
    jsc, sc = scenes
    want = from_reference(jsc.state0)
    np.testing.assert_array_equal(sc.state0.pos, want.pos)
    np.testing.assert_allclose(sc.state0.ref_angle, want.ref_angle, rtol=0,
                               atol=1e-12)
    assert np.count_nonzero(want.ref_angle) > 0, "the pre-curl yielded none"
    for name in ("frozen", "mass"):
        np.testing.assert_array_equal(getattr(sc.spec, name),
                                      np.asarray(getattr(jsc.spec, name)))
    assert (sc.spec.solver, sc.spec.plastic, sc.spec.dia) == ("dense", True,
                                                              None)


@pytest.mark.parametrize("k", [9, 12])
def test_project_psd_matches_jax(k):
    """Seeded symmetric blocks, a third with repeated eigenvalues (a
    repeated negative pair, a repeated positive triple, a repeated zero):
    the clamped projection is unique where the eigenvectors are not."""
    rng = np.random.default_rng(k)
    n = 96
    A = rng.normal(size=(n, k, k))
    H = A + np.swapaxes(A, 1, 2)
    lam = rng.normal(size=(n // 3, k))
    lam[:, 0:2] = -1.5
    lam[:, 2:5] = 2.0
    lam[:, 5:7] = 0.0
    Q, _ = np.linalg.qr(rng.normal(size=(n // 3, k, k)))
    H[: n // 3] = np.einsum("nik,nk,njk->nij", Q, lam, Q)
    got = spd.project_psd(torch.as_tensor(H))
    assert _rel(got, jspd.project_psd(jnp.asarray(H))) < EVAL_RTOL
    assert float(torch.linalg.eigvalsh(got).min()) > -1e-12
    assert torch.equal(spd.project_psd_method(torch.as_tensor(H), "eigh"),
                       got)


@pytest.fixture(scope="module")
def evals(scenes, ref):
    """The port's element evaluations on JAX's contact set at the
    perturbed state."""
    spec, s0, params = scenes[1].to("cpu")
    contact = from_reference(ref[2]).to("cpu")
    pert, pdir = (torch.as_tensor(v) for v in _perturbations(scenes[0].spec))
    pos = s0.pos + pert
    groups = elements.all_groups(spec, params, pos, s0.ref_angle, contact,
                                 with_hess=True, spd=True)
    F = elements.assemble_residual(spec, groups, pos, s0.pos, s0.vel)
    E_of = elements.linesearch_energy_fn(spec, params, pos, pdir, s0.pos,
                                         s0.vel, s0.ref_angle, contact)
    return dict(H=elements.dense_hessian(spec, groups), F=F,
                p=solver.solve_dense(spec, groups, F),
                E=torch.stack([E_of(a) for a in ALPHAS]))


def test_dense_hessian_and_scatter_residual_match_jax(evals, ref):
    want = ref[3]
    assert evals["H"].shape == want["H"].shape
    assert _rel(evals["H"], want["H"]) < EVAL_RTOL
    assert _rel(evals["F"], want["F"]) < EVAL_RTOL
    # symmetric, with the inertia diagonal on every DOF, frozen ones too
    H = evals["H"]
    assert float((H - H.T).abs().max()) <= 1e-12 * float(H.abs().max())


def test_linesearch_energy_matches_jax(evals, ref):
    """E(alpha) at three alphas, against JAX's and against the total
    energy at pos - alpha p."""
    assert _rel(evals["E"], ref[3]["E"]) < EVAL_RTOL
    assert _rel(evals["E"], ref[3]["E_tot"]) < EVAL_RTOL


def test_solve_dense_matches_jax(evals, ref):
    assert _rel(evals["p"], ref[3]["p"]) < 1e-9


def test_rollout_matches_jax(port, ref):
    """Full Newton on the dense solve with plastic rest-angle updates."""
    _spec, _s0, _params, buf, _res, stats = port
    jbuf = ref[0]
    assert buf["pos"].shape == jbuf["pos"].shape
    np.testing.assert_allclose(buf["pos"].numpy(), jbuf["pos"], rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(buf["ref_angle"].numpy(), jbuf["ref_angle"],
                               rtol=0, atol=REF_ATOL)
    np.testing.assert_array_equal(buf["yield_gate"].numpy(),
                                  jbuf["yield_gate"])
    assert jbuf["yield_gate"][1:].any(), "no hinge yielded in the rollout"
    assert np.abs(jbuf["ref_angle"][-1] - jbuf["ref_angle"][0]).max() > 0
    assert stats["cg_iters"] == 0 and stats["hess_builds"] == \
        stats["newton_iters"]
    assert len(stats["newton_per_step"]) == N_STEPS
    assert sum(stats["newton_per_step"]) == stats["newton_iters"]
    assert stats["ls_trials"] >= stats["newton_iters"]


def test_backward_matches_jax(port, ref):
    """The dense-solve adjoint on the port's own tape."""
    res, jres = port[4], ref[1]
    assert float(np.abs(jres.gripper_grad).max()) > 0
    assert _rel(res.gripper_grad, jres.gripper_grad) < GRAD_RTOL
    assert _rel(res.pos_grad0, jres.pos_grad0) < GRAD_RTOL


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _golden.save(REFERENCE, _reference())
