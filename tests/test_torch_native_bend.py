"""The port's native topology helper and the batched hinge form against
their numpy versions and the JAX package's (CPU).

- The native cloth tables, hinge stencils and cube lattice equal the
  port's numpy paths and the JAX package's, integer for integer, and
  `build_cloth_mesh(exact_adjacency=True)` equals JAX's.
- `bending_energy_batch` agrees with JAX's and with the port's per-hinge
  form to rtol 5e-15 (JAX's own bound, tests/test_energies.py); its
  masked gradient (the VJP with the hinge mask) with the per-hinge one.
- A T=2 rollout of `bench_scene.make(cloth_N=8, table_n=4, solver=
  "dense")` with `bend_batch=True` against the JAX package's run stored
  in tests/data/bend_batch_golden.npz (scripts/make_debug_bend_goldens.py;
  the grid jittered by 1e-6 m as in tests/test_torch_stepper.py, the pad
  pressing 2 mm a step), within 1e-9 m, and against the port's default
  form; its backward, parameter gradient included, against the default
  form's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu import native as jnative
from thinshelllab_tpu.core import topology as jtopology
from thinshelllab_tpu.ops import energies as jen
from thinshelllab_torch import native
from thinshelllab_torch.core import builder, topology
from thinshelllab_torch.engine import adjoint, elements, stepper
from thinshelllab_torch.ops import energies as en
from thinshelllab_torch.scenes import bench_scene
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "bend_batch_golden.npz")
SIZES = [(3, 5), (8, 8), (16, 7)]
# the two hinge forms: the same arithmetic, a few operations ordered
# differently (JAX's bound, tests/test_energies.py)
BATCH_RTOL = 5e-15
# positions in metres after 2 steps (scene 0.1 m), as tests/test_torch_stepper
POS_ATOL = 1e-9
# the two forms' gradients, of the largest entry (the same arithmetic to
# rounding, through a linear solve)
GRAD_RTOL = 1e-9
# the rollout's configuration and actions, as scripts/make_debug_bend_goldens
BEND_CFG = dict(cloth_N=8, table_n=4, solver="dense", max_newton_iter=4)
BEND_T = 2
BEND_DZ = -2e-3


def _jax_numpy_path(fn, *args):
    """Run a JAX-package builder with its native helper off."""
    os.environ["TSL_NO_NATIVE"] = "1"
    jnative._tried, jnative._lib = False, None
    try:
        return fn(*args)
    finally:
        del os.environ["TSL_NO_NATIVE"]
        jnative._tried, jnative._lib = False, None


@pytest.mark.parametrize("N,M", SIZES)
def test_native_tables_match_numpy_and_jax(N, M):
    got = native.cloth_mesh_tables(N, M)
    assert got is not None
    jm = _jax_numpy_path(jtopology.build_cloth_mesh, N, M)
    want = (jm.f2v, jm.counter_face, jm.counter_point, jm.indices)
    for g, n, w in zip(got, topology.cloth_tables_numpy(N, M), want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, n)
        np.testing.assert_array_equal(g, w)
    mesh = topology.build_cloth_mesh(N, M)
    np.testing.assert_array_equal(mesh.hinge_mask, jm.hinge_mask)
    np.testing.assert_array_equal(mesh.uv, jm.uv)

    pos = np.random.default_rng(N * 100 + M).normal(size=(mesh.NV, 3)) * 0.01
    hv = builder.build_hinges(mesh, pos)
    from thinshelllab_tpu.core import builder as jbuilder
    jhv = _jax_numpy_path(jbuilder._build_hinges, jm, pos)
    for g, n, w in zip(hv, builder.build_hinges_numpy(mesh, pos), jhv):
        np.testing.assert_array_equal(g, n)
        np.testing.assert_array_equal(g, w)

    dims = (N % 5 + 2, M % 4 + 2, 3)
    t = native.cube_tets(*dims)
    np.testing.assert_array_equal(t, topology.cube_tets_numpy(*dims))
    np.testing.assert_array_equal(
        t, _jax_numpy_path(jtopology.build_cube_tet_mesh, *dims, 0.03).tets)


def test_exact_adjacency_matches_jax():
    for N, M in SIZES:
        got = topology.build_cloth_mesh(N, M, exact_adjacency=True)
        want = jtopology.build_cloth_mesh(N, M, exact_adjacency=True)
        for name in ("f2v", "counter_face", "counter_point", "hinge_mask",
                     "indices"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


def test_no_native_takes_numpy(monkeypatch):
    monkeypatch.setenv("TSL_NO_NATIVE", "1")
    assert native.cloth_mesh_tables(4, 4) is None
    assert native.cube_tets(3, 3, 3) is None
    mesh = topology.build_cloth_mesh(4, 4)
    np.testing.assert_array_equal(mesh.f2v, topology.cloth_tables_numpy(4, 4)[0])


def _soup(NH=257, seed=3):
    """Random hinge soup with non-degenerate stencils (JAX's test)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(NH, 4, 3))

    def valid_sel():
        ja, jb = rng.permutation(3)[:2]
        ea, eb = rng.permutation(4)[:2]
        return en.stencil_to_sel(ja, jb, ea, eb)

    sel = np.stack([valid_sel() for _ in range(NH)])
    ref = rng.normal(size=NH) * 0.1
    coef = rng.uniform(0.5, 2.0, NH)
    kb = rng.uniform(0.5, 2.0, NH)
    return x, sel, ref, coef, kb


def test_bending_energy_batch_matches():
    args = _soup()
    np.testing.assert_array_equal(args[1][0], jen.stencil_to_sel(
        *np.argmax(args[1][0], axis=1)))
    t = [torch.as_tensor(a) for a in args]
    e_batch = en.bending_energy_batch(*t).numpy()
    want = np.asarray(jax.jit(jen.bending_energy_batch)(
        *(jnp.asarray(a) for a in args)))
    # against JAX relative to the soup's largest energy, the convention of
    # tests/test_torch_energies.py: XLA contracts multiply-adds into FMAs
    # (ROADMAP.md §3), and where theta is within 1e-3 of its rest angle the
    # square of the difference keeps ~1e-14 relative of that rounding
    # (3 of 257 hinges here; JAX's own eager and jitted forms differ by
    # 3.4e-15 on the same soup)
    np.testing.assert_allclose(e_batch, want, rtol=BATCH_RTOL,
                               atol=BATCH_RTOL * np.abs(want).max())
    np.testing.assert_allclose(e_batch, en.bending_energy(*t).numpy(),
                               rtol=BATCH_RTOL, atol=0)

    # the masked gradient: VJP with the 0/1 mask against the per-hinge
    # gradient times the mask
    m = torch.as_tensor((np.arange(len(args[0])) % 3 != 0).astype(float))
    _, vjp = torch.func.vjp(lambda xx: en.bending_energy_batch(xx, *t[1:]),
                            t[0])
    (g_batch,) = vjp(m)
    g_hinge = torch.func.grad(lambda xx: en.bending_energy(xx, *t[1:]).sum())(
        t[0]) * m[:, None, None]
    np.testing.assert_allclose(g_batch.numpy(), g_hinge.numpy(), rtol=1e-12,
                               atol=1e-12)


def _bend_scene():
    sc = bench_scene.make(dtype=torch.float64, **BEND_CFG)
    spec, s0, params = sc.to("cpu")
    gold = np.load(GOLDEN)["pos"]
    s0 = s0.replace(pos=torch.as_tensor(gold[0]))
    dpos = np.zeros((BEND_T, 1, 3))
    dpos[:, 0, 2] = BEND_DZ
    acts = (torch.as_tensor(dpos), torch.zeros((BEND_T, 1, 3),
                                               dtype=torch.float64),
            torch.zeros((BEND_T, 1), dtype=torch.float64))
    return spec, s0, params, acts, gold


def test_bend_batch_rollout_matches_jax():
    """The batch form's rollout against the JAX golden and the default
    form; its backward (the parameter gradient takes autograd through the
    hinge gradient) against the default form's."""
    spec, s0, params, acts, gold = _bend_scene()
    n_cloth = (BEND_CFG["cloth_N"] + 1) ** 2
    jit0 = gold[0, :n_cloth] - bench_scene.make(
        dtype=torch.float64, **BEND_CFG).state0.pos[:n_cloth]
    assert 1e-7 < np.abs(jit0).max() < 1e-5  # the 1e-6 m jitter
    seed = bench_scene.make(dtype=torch.float64, **BEND_CFG).seed_loss
    runs = []
    for sp in (spec.replace(bend_batch=True), spec):
        _, buf = stepper.simulate(sp, params, s0, acts, save_contacts=True)
        runs.append((buf, adjoint.backward(sp, params, buf, *seed(buf),
                                           with_param_grad=True)))
    (buf, res), (ref, res_d) = runs
    pos = buf["pos"].numpy()
    np.testing.assert_allclose(pos, gold, rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(pos, ref["pos"].numpy(), rtol=0,
                               atol=POS_ATOL)
    for got, want in ((res.gripper_grad, res_d.gripper_grad),
                      (res.param_grad.kb, res_d.param_grad.kb)):
        want = want.numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())
    # the hinges bend in this run
    th0 = elements.bending_eval(spec, params, buf["pos"][0],
                                s0.ref_angle, False, False)[0]
    th2 = elements.bending_eval(spec, params, buf["pos"][-1],
                                s0.ref_angle, False, False)[0]
    assert float(th2) > float(th0)


def test_bend_batch_env_reaches_every_path(monkeypatch):
    """TSL_BEND_BATCH=1 makes the builder's spec take the batch form; its
    energy, line-search energy and forces equal the default form's to
    rounding."""
    monkeypatch.setenv("TSL_BEND_BATCH", "1")
    sc = bench_scene.make(dtype=torch.float64, cloth_N=4, table_n=3,
                          solver="dense")
    assert sc.spec.bend_batch
    spec_b, s0, params = sc.to("cpu")
    spec_d = spec_b.replace(bend_batch=False)
    rng = np.random.default_rng(0)
    pos = s0.pos + torch.as_tensor(1e-4 * rng.standard_normal(s0.pos.shape))
    p = torch.as_tensor(1e-5 * rng.standard_normal(s0.pos.shape))
    contact, _, _ = stepper.build_contacts(spec_b, params, pos, pos,
                                           s0.proj_flag, s0.proj_dir)
    out = []
    for sp in (spec_b, spec_d):
        E = elements.total_energy(sp, params, pos, s0.pos, s0.vel,
                                  s0.ref_angle, contact)
        E_of = elements.linesearch_energy_fn(sp, params, pos, p, s0.pos,
                                             s0.vel, s0.ref_angle, contact)
        g = elements.all_groups(sp, params, pos, s0.ref_angle, contact,
                                with_hess=False, spd=False)["g"]
        out.append((float(E), float(E_of(0.5)), g))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-14)
    assert out[0][1] == pytest.approx(out[1][1], rel=1e-14)
    np.testing.assert_allclose(out[0][2].numpy(), out[1][2].numpy(),
                               rtol=1e-12, atol=1e-14)
