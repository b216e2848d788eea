"""The port's adjoint against the JAX package's, on a small bench scene in
f64 on the CPU: the |D|^-1 blocks, the (NV, 3) operator, the grid (BCR)
preconditioner, GMRES, and the whole backward sweep on one carried JAX
tape; and the saved golden gradients that chip_smoke.py holds the CUDA run
against.

The pad presses 2 mm a step for T=4 steps (the bench's 0.4 mm never
reaches the cloth in a few steps on this scene, and the gripper gradient
would be zero), from the grid jittered by 1e-6 m (numpy seed 0, as in
test_torch_stepper.py). adj_tol 1e-10 keeps every GMRES iteration count
away from its exit test, so both packages take the same iterations.

The JAX reference's tape and outputs are stored in
tests/data/bench8_adjoint_reference_golden.npz, which the tests read; only
test_golden_file_is_current (marked slow) runs the JAX package, and holds
both golden files to what it computes today.

Regenerate the golden files (after a deliberate change of the reference):
    OPENBLAS_NUM_THREADS=1 PYTHONPATH=. python tests/test_torch_adjoint.py
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.engine import adjoint as jadjoint
from thinshelllab_tpu.engine import elements as jelements
from thinshelllab_tpu.engine import gridsolve as jgrid
from thinshelllab_tpu.engine import solver as jsolver
from thinshelllab_tpu.engine import stepper as jstepper
from thinshelllab_tpu.ops import spd as jspd
from thinshelllab_tpu.scenes import bench_scene as jbench
from thinshelllab_torch.core.convert import buffers_from_reference
from thinshelllab_torch.core.spec import ContactSet
from thinshelllab_torch.engine import adjoint, elements, gridsolve, solver
from thinshelllab_torch.engine import stepper
from thinshelllab_torch.ops import spd
from thinshelllab_torch.scenes import bench_scene
import _golden
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "bench8_adjoint_golden.npz")
REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                         "bench8_adjoint_reference_golden.npz")
CFG = dict(cloth_N=8, table_n=4, solver="cg", hess_refresh=8,
           max_newton_iter=4, fwd_tol=1e-10, adj_tol=1e-10)
T = 4
DPOS_Z = -2e-3
STEP = 2  # the step whose linear system the operator tests use
# the same arithmetic with sums in another order, through GMRES to 1e-10:
# max |port - JAX| / max |JAX| (observed 1e-12 and below)
GRAD_RTOL = 1e-9
# one operator apply, factorization or preconditioner apply (observed
# 1e-14 and below)
OP_RTOL = 1e-12


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _jittered_pos0(pos0):
    pos0 = np.array(pos0, dtype=np.float64)
    n = (CFG["cloth_N"] + 1) ** 2
    pos0[:n] += 1e-6 * np.random.default_rng(0).normal(size=(n, 3))
    return pos0


def _actions():
    dpos = np.zeros((T, 1, 3))
    dpos[:, 0, 2] = DPOS_Z
    return dpos, np.zeros((T, 1, 3)), np.zeros((T, 1))


def _jax_backward(spec, params, buffers, seeds, **kw):
    """The JAX sweep with its scan outputs: (per-step gripper gradients in
    sweep order, GMRES iterations, residual dL/dx_0, Params cotangent)."""
    opts = dict(damping_grad=1.0, vertical_only=False, with_param_grad=True,
                skip_steps=0, friction_loss=False, f_loss_ratio=0.001,
                warm_start=False, debug_iters=False)
    opts.update(kw)
    comp = opts.pop("compensated", False)
    fin, ggs, iters = jadjoint._backward_body(
        spec, params, buffers, *seeds, **opts, cd=jnp.float64,
        sd=jnp.float64, comp=comp, solve_prec="highest", raw=True)
    g0 = fin[0] + fin[7] if comp else fin[0]
    return dict(gg=ggs, iters=iters, pos_grad0=g0, param_grad=fin[5])


def _jax_operator(spec, params, buffers, z, r, F):
    """Every stage of one adjoint linear system at STEP, on the taped
    contact set."""
    contact = jax.tree.map(lambda x: x[STEP - 1], buffers["contact"])
    groups = jelements.all_groups(
        spec, params, buffers["pos"][STEP], buffers["ref_angle"][STEP - 1],
        contact, with_hess=True, spd=False)
    st = jsolver.prepare_solver_state(spec, groups, jnp.float64)
    A, _ = jsolver._ops_from_state(spec, st)
    gp = jgrid.build_grid_plan(spec)
    ns = jelements.static_block_count(spec)
    dia_pc = jgrid.add_contact_couplings(
        spec, gp, jgrid.contact_coupling_slots(spec, gp), st["dia"],
        groups["idx"][ns:], groups["H"][ns:])
    D, U = jgrid.extract_cloth_tridiag(spec, gp[0], dia_pc, st["Dc"])
    fac = jgrid.factor_tridiag(D, U, cutoff=spec.bcr_cutoff)
    rb = r.reshape(-1)[: D.shape[0] * D.shape[1]].reshape(D.shape[:2])
    Dinv = jspd.abs_inv_3x3(st["D"])
    pre = jgrid.GridPreconditioner(spec, gp, dia_pc, Dinv, st["Dc"])
    x, it = jsolver.solve_gmres(spec, groups, F, return_iters=True)
    return dict(Az=A(z), fz=jelements.frozen_column_product(spec, groups, z),
                xd=jsolver.solve_dense(spec, groups, F),
                dia=st["dia"], dia_pc=dia_pc, D=D, U=U,
                tri=jgrid.solve_tridiag(fac, rb),
                Mr=pre.apply(r), x=x, it=it)


def _reference():
    sc = jbench.make(dtype=jnp.float64, **CFG)
    spec, params = sc.spec, sc.params
    pos0 = _jittered_pos0(sc.state0.pos)
    state0 = jax.tree.map(jnp.asarray, sc.state0.replace(pos=pos0))
    acts = tuple(jnp.asarray(a) for a in _actions())
    _, buf = jax.jit(lambda s, a: jstepper.simulate(
        spec, params, s, a, save_contacts=True))(state0, acts)
    seeds = sc.seed_loss(buf)
    notape = {k: v for k, v in buf.items() if k != "contact"}
    rng = np.random.default_rng(3)
    z, r, F = (jnp.asarray(rng.normal(size=(spec.NV, 3))) for _ in range(3))

    def run(buf, notape, seeds, z, r, F):
        return (_jax_backward(spec, params, notape, seeds,
                              with_param_grad=False),
                _jax_backward(spec, params, buf, seeds, friction_loss=True,
                              compensated=True),
                _jax_operator(spec, params, buf, z, r, F))

    A, B, op = jax.jit(run)(buf, notape, seeds, z, r, F)
    tonp = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(pos0=pos0, buf=tonp(buf), A=tonp(A), B=tonp(B),
                op=tonp(op), zrF=tuple(np.asarray(v) for v in (z, r, F)))


def _golden_tree(r):
    """_reference()'s outputs as REFERENCE stores them: the tape under
    "tape", the A sweep without the Params cotangent it does not compute."""
    return dict(pos0=r["pos0"], zrF=np.stack(r["zrF"]), tape=r["buf"],
                A={k: r["A"][k] for k in ("gg", "iters", "pos_grad0")},
                B=r["B"], op=r["op"])


def _by_step(ggs):
    """(T+1, n_part, 6) from the sweep-order rows t = T .. 1."""
    out = np.zeros((T + 1,) + ggs.shape[1:])
    out[np.arange(T, 0, -1)] = ggs
    return out


@pytest.fixture(scope="module")
def ref():
    """REFERENCE in _reference()'s shapes: the tape's ContactSet as the
    port's dataclass, the Params cotangent as a namespace of its fields."""
    g = _golden.load(REFERENCE)
    g["tape"]["contact"] = ContactSet(**g["tape"]["contact"])
    g["B"]["param_grad"] = types.SimpleNamespace(**g["B"]["param_grad"])
    return dict(pos0=g["pos0"], buf=g["tape"], A=g["A"], B=g["B"],
                op=g["op"], zrF=tuple(g["zrF"]))


@pytest.fixture(scope="module")
def port(ref):
    sc = bench_scene.make(dtype=torch.float64, **CFG)
    spec, s0, params = sc.to("cpu")
    buf = buffers_from_reference(ref["buf"])
    return sc, spec, params, buf, sc.seed_loss(buf), s0


@pytest.fixture(scope="module")
def operator(port, ref):
    """The port's stages of the STEP system, built from the carried tape."""
    _sc, spec, params, buf, _seeds, _s0 = port
    tape = buf["contact"]
    contact = tape.replace(**{f.name: getattr(tape, f.name)[STEP - 1]
                              for f in dataclasses.fields(tape)})
    groups = elements.all_groups(spec, params, buf["pos"][STEP],
                                 buf["ref_angle"][STEP - 1], contact,
                                 with_hess=True, spd=False)
    st = solver.prepare_solver_state(spec, groups, torch.float64)
    return spec, groups, st, [torch.tensor(v) for v in ref["zrF"]]


def _dia_pc(spec, groups, st):
    ns = elements.static_block_count(spec)
    return gridsolve.add_contact_couplings(
        spec, spec.dev.grid_plan, spec.dev.coupling_slots, st["dia"],
        groups["idx"][ns:], groups["H"][ns:])


def _sym(rng, n, scale=1.0):
    A = rng.normal(size=(n, 3, 3)) * scale
    return 0.5 * (A + np.swapaxes(A, -1, -2))


def _rotated(rng, lam):
    Q, _ = np.linalg.qr(rng.normal(size=(lam.shape[0], 3, 3)))
    return np.einsum("nik,nk,njk->nij", Q, lam, Q)


def test_abs_inv_3x3_matches_jax():
    """Random symmetric, indefinite, clustered and scalar blocks, as
    tests/test_solver_precond.py builds them."""
    rng = np.random.default_rng(0)
    n = 64
    indef = np.stack([rng.uniform(0.5, 2, n), -rng.uniform(0.5, 2, n),
                      rng.uniform(3, 9, n)], axis=-1)
    blocks = np.concatenate([
        _sym(rng, n, 3.0), _rotated(rng, indef),
        _rotated(rng, np.array([[1.0, 1.0 + 3e-9, 5.0]] * 16)),
        np.eye(3)[None] * rng.uniform(-2, 2, (16, 1, 1))])
    want = np.asarray(jax.jit(jspd.abs_inv_3x3)(jnp.asarray(blocks)))
    got = spd.abs_inv_3x3(torch.as_tensor(blocks))
    # the same closed form; cos/acos round differently in the two
    # libraries, and the divided differences over the 3e-9 cluster amplify
    # that by up to eps / 3e-9 (observed 1.8e-11)
    assert _rel(got, want) < 1e-9
    got32 = spd.abs_inv_3x3(torch.as_tensor(blocks, dtype=torch.float32))
    assert got32.dtype == torch.float32
    assert _rel(got32.double(), want) < 1e-3


def test_hvp_dia_and_frozen_column_product_match_jax(operator, ref):
    spec, groups, st, (z, _r, _F) = operator
    op = ref["op"]
    A = solver._ops_from_state(spec, st)
    assert _rel(st["dia"], op["dia"]) < OP_RTOL
    assert _rel(A(z), op["Az"]) < OP_RTOL
    assert _rel(elements.frozen_column_product(spec, groups, z),
                op["fz"]) < OP_RTOL


def test_add_contact_couplings_leaves_the_operator_store(operator, ref):
    spec, groups, st, _ = operator
    before = st["dia"].clone()
    dia_pc = _dia_pc(spec, groups, st)
    assert torch.equal(st["dia"], before)
    assert not torch.equal(dia_pc, before), "no coupling was added"
    assert _rel(dia_pc, ref["op"]["dia_pc"]) < OP_RTOL


def test_grid_preconditioner_matches_jax(operator, ref):
    spec, groups, st, (_z, r, _F) = operator
    op = ref["op"]
    gp = spec.dev.grid_plan
    assert gp == tuple(jgrid.build_grid_plan(
        jbench.make(dtype=jnp.float64, **CFG).spec))
    dia_pc = _dia_pc(spec, groups, st)
    D, U = gridsolve.extract_cloth_tridiag(spec, gp[0], dia_pc, st["Dc"])
    assert _rel(D, op["D"]) < OP_RTOL and _rel(U, op["U"]) < OP_RTOL
    fac = gridsolve.factor_tridiag(D, U, cutoff=spec.bcr_cutoff)
    assert len(fac[0]) >= 1, "no reduction level ran"
    rb = r.reshape(-1)[: D.shape[0] * D.shape[1]].reshape(D.shape[:2])
    x = gridsolve.solve_tridiag(fac, rb)
    assert _rel(x, op["tri"]) < OP_RTOL
    # the factorization solves its own system
    Tx = torch.einsum("kab,kb->ka", D, x)
    Tx[:-1] += torch.einsum("kab,kb->ka", U[:-1], x[1:])
    Tx[1:] += torch.einsum("kba,kb->ka", U[:-1], x[:-1])
    # explicit block inverses: the residual is cond(T) eps (observed 3e-8)
    assert _rel(Tx, rb.numpy()) < 1e-6
    pre = gridsolve.GridPreconditioner(spec, gp, dia_pc,
                                       spd.abs_inv_3x3(st["D"]), st["Dc"])
    assert _rel(pre.apply(r), op["Mr"]) < OP_RTOL


def test_solve_gmres_matches_jax(operator, ref):
    spec, groups, _st, (_z, _r, F) = operator
    x, it = solver.solve_adjoint(spec, groups, F, return_iters=True)
    assert it == int(ref["op"]["it"]) > 1
    assert _rel(x, ref["op"]["x"]) < GRAD_RTOL


def test_backward_matches_jax(port, ref):
    """Default options, contacts rebuilt from the tape's positions; and the
    debug iteration counts."""
    _sc, spec, params, buf, seeds, _s0 = port
    notape = {k: v for k, v in buf.items() if k != "contact"}
    A = ref["A"]
    res = adjoint.backward(spec, params, notape, *seeds)
    want = _by_step(A["gg"])
    assert res.gripper_grad.dtype == torch.float64
    assert _rel(res.gripper_grad, want) < GRAD_RTOL
    assert int((np.abs(want).max(axis=(1, 2)) > 0).sum()) >= 3
    assert _rel(res.pos_grad0, A["pos_grad0"]) < GRAD_RTOL
    # skip_steps / vertical_only mask the gathered rows and leave the chain
    res2 = adjoint.backward(spec, params, notape, *seeds, debug_iters=True,
                            skip_steps=1, vertical_only=True)
    np.testing.assert_array_equal(res2.pos_grad0.numpy(), A["iters"])
    masked = want.copy()
    masked[: 2] = 0.0
    masked[..., [0, 1, 3, 4, 5]] = 0.0
    assert _rel(res2.gripper_grad, masked) < GRAD_RTOL


def test_backward_on_the_taped_contacts_matches_jax(port, ref):
    """The taped contact sets with the slip-penalty seed, compensated
    carries and the Params cotangent."""
    _sc, spec, params, buf, seeds, _s0 = port
    B = ref["B"]
    res = adjoint.backward(spec, params, buf, *seeds, with_param_grad=True,
                           friction_loss=True, compensated=True)
    assert _rel(res.gripper_grad, _by_step(B["gg"])) < GRAD_RTOL
    assert _rel(res.pos_grad0, B["pos_grad0"]) < GRAD_RTOL
    for f in dataclasses.fields(res.param_grad):
        got, w = getattr(res.param_grad, f.name), getattr(B["param_grad"],
                                                          f.name)
        assert _rel(got, w) < GRAD_RTOL, f.name
    assert np.abs(B["param_grad"].mu_pairs).max() > 0


def test_save_contacts_tape_matches_jax(port, ref):
    """The port's own forward tapes the contact sets the JAX forward does
    (the first two steps)."""
    _sc, spec, params, _buf, _seeds, s0 = port
    s0 = s0.replace(pos=torch.as_tensor(ref["pos0"]))
    _, tb = stepper.simulate(spec, params, s0,
                             tuple(torch.as_tensor(a[:2]) for a in _actions()),
                             save_contacts=True)
    np.testing.assert_allclose(tb["pos"].numpy(), ref["buf"]["pos"][:3],
                               rtol=0, atol=1e-9)
    want = ref["buf"]["contact"]
    for f in dataclasses.fields(tb["contact"]):
        got, w = getattr(tb["contact"], f.name), getattr(want, f.name)[:2]
        assert tuple(got.shape) == w.shape, f.name
        if got.is_floating_point():
            assert _rel(got, w) < 1e-9, f.name
        else:
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f.name)


@pytest.mark.slow
def test_golden_file_is_current():
    """The saved golden gradients, and the reference the other tests read,
    are what JAX computes today."""
    live = _reference()
    g = np.load(GOLDEN)
    A = live["A"]
    np.testing.assert_array_equal(g["pos0"], live["pos0"])
    np.testing.assert_array_equal(g["dpos"], _actions()[0])
    np.testing.assert_allclose(g["pos"], live["buf"]["pos"], rtol=0,
                               atol=1e-12)
    assert _rel(g["gripper_grad"], _by_step(A["gg"])) < GRAD_RTOL
    assert _rel(g["pos_grad0"], A["pos_grad0"]) < GRAD_RTOL
    np.testing.assert_array_equal(g["iters"], A["iters"])
    for key in ("cloth_N", "table_n", "max_newton_iter"):
        assert int(g[key]) == CFG[key]
    assert float(g["fwd_tol"]) == CFG["fwd_tol"]
    assert float(g["adj_tol"]) == CFG["adj_tol"]
    _golden.assert_current(REFERENCE, _golden_tree(live), _assert_entry)


def _assert_entry(key, got, want):
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=key)
    elif key.startswith(("pos0", "tape.pos", "zrF")):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=key)
    else:
        # the operator stages at OP_RTOL, solutions and gradients at
        # GRAD_RTOL, as the tests hold the port to them
        tol = (OP_RTOL if key.startswith("op.")
               and key not in ("op.x", "op.xd") else GRAD_RTOL)
        assert _rel(got, want) < tol, key


def test_float32_backward_stays_float32():
    """The card's working type: the forward and every backward output stay
    float32 (a float64 leak makes the kernels refuse their inputs)."""
    sc = bench_scene.make(dtype=torch.float32,
                          **{**CFG, "fwd_tol": 1e-3, "adj_tol": None})
    spec, s0, params = sc.to("cpu")
    acts = tuple(torch.as_tensor(a, dtype=torch.float32) for a in _actions())
    _, buf = stepper.simulate(spec, params, s0, acts, save_contacts=True)
    seeds = sc.seed_loss(buf)
    res = adjoint.backward(spec, params, buf, *seeds, with_param_grad=True,
                           friction_loss=True, compensated=True,
                           warm_start=True)
    for name, v in (("gripper_grad", res.gripper_grad),
                    ("pos_grad0", res.pos_grad0),
                    *((f.name, getattr(res.param_grad, f.name))
                      for f in dataclasses.fields(res.param_grad))):
        assert v.dtype == torch.float32, name
        assert bool(torch.isfinite(v).all()), name
    assert float(res.gripper_grad.abs().max()) > 0


def test_dense_adjoint_solve_matches_jax(operator, ref):
    """solve_adjoint on the dense path (the LU solve of the assembled true
    Hessian, once an unported branch) against JAX's solve_dense on the
    same operator."""
    spec, groups, _st, (_z, _r, F) = operator
    x, it = solver.solve_adjoint(spec.replace(solver="dense"), groups, F,
                                 x0=torch.ones_like(F), return_iters=True)
    assert it == 0
    assert _rel(x, ref["op"]["xd"]) < GRAD_RTOL
    assert _rel(x, ref["op"]["x"]) < 1e-6  # GMRES to adj_tol 1e-10


def test_unported_branches_raise(operator, ref, port, monkeypatch):
    """The branches that raised before they were ported: solve_adjoint on
    the spec without a cloth grid plan takes MINRES (preconditioned by the
    smoothing polynomial of the |H| DIA operator), against the JAX
    package's on the same system with its grid plan taken away (the same
    iterations within 2, the solution within 1e-10); and
    backward_chunked is bit-equal to backward on the carried tape."""
    spec, groups, _st, (_z, _r, F) = operator
    no_grid = spec.replace(dev=dataclasses.replace(spec.dev, grid_plan=()))
    x, it = solver.solve_adjoint(no_grid, groups, F, return_iters=True)
    jspec = jbench.make(dtype=jnp.float64, **CFG).spec
    jgroups = {"idx": jnp.asarray(groups["idx"].numpy().astype(np.int32)),
               "H": jnp.asarray(groups["H"].numpy())}
    monkeypatch.setattr(jgrid, "build_grid_plan", lambda spec: [])
    jx, jit_ = jax.jit(lambda g, b: jsolver.solve_adjoint(
        jspec, g, b, return_iters=True))(jgroups, jnp.asarray(F.numpy()))
    assert abs(it - int(jit_)) <= 2 and 0 < it < spec.cg_max_iter
    assert _rel(x, jx) < 1e-10
    assert _rel(x, ref["op"]["xd"]) < 1e-6  # the dense solve
    _sc, spec, params, buf, seeds, _s0 = port
    want = adjoint.backward(spec, params, buf, *seeds)
    got = adjoint.backward_chunked(spec, params, buf, *seeds, 2)
    assert torch.equal(got.gripper_grad, want.gripper_grad)
    assert torch.equal(got.pos_grad0, want.pos_grad0)


def _write_golden():
    r = _reference()
    _golden.save(REFERENCE, _golden_tree(r))
    A = r["A"]
    np.savez_compressed(
        GOLDEN, pos0=r["pos0"], dpos=_actions()[0], pos=r["buf"]["pos"],
        gripper_grad=_by_step(A["gg"]), pos_grad0=A["pos_grad0"],
        iters=A["iters"], cloth_N=CFG["cloth_N"], table_n=CFG["table_n"],
        max_newton_iter=CFG["max_newton_iter"], fwd_tol=CFG["fwd_tol"],
        adj_tol=CFG["adj_tol"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _write_golden()
