"""The port's forward rollout against the JAX package's, on a small bench
scene in f64 on the CPU, and the saved golden positions that chip_smoke.py
holds the CUDA run against.

The cloth starts jittered by 1e-6 m (numpy seed 0): on the exact grid some
contact queries sit at exact ties between coplanar faces, which the JAX
package itself breaks differently under jit and op by op; the jitter makes
every face choice robust to summation order.

The JAX rollouts the tests compare with are stored in
tests/data/bench8_rollout_reference_golden.npz; only
test_golden_file_is_current (marked slow) runs the JAX package, and holds
both golden files to what it computes today.

Regenerate the golden files (after a deliberate change of the reference):
    OPENBLAS_NUM_THREADS=1 PYTHONPATH=. python tests/test_torch_stepper.py
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.engine import stepper as jstepper
from thinshelllab_tpu.scenes import bench_scene as jbench
from thinshelllab_torch.engine import stepper
from thinshelllab_torch.scenes import bench_scene
import _golden
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "bench8_golden.npz")
REFERENCE = os.path.join(os.path.dirname(__file__), "data",
                         "bench8_rollout_reference_golden.npz")
CFG = dict(cloth_N=8, table_n=4, solver="cg", hess_refresh=8,
           max_newton_iter=4, fwd_tol=1e-10)
# the rollouts REFERENCE keeps, by name
REFERENCE_CFGS = {"default": CFG, "refresh1": {**CFG, "hess_refresh": 1}}
T = 2
# positions in metres (scene 0.1 m, 8e-4 m of motion over the rollout):
# same arithmetic, sums in another order
POS_ATOL = 1e-9


def _jittered_pos0(pos0, n_cloth):
    pos0 = np.array(pos0, dtype=np.float64)
    pos0[:n_cloth] += 1e-6 * np.random.default_rng(0).normal(size=(n_cloth, 3))
    return pos0


def _actions():
    dpos = np.zeros((T, 1, 3))
    dpos[:, 0, 2] = -4e-4  # bench.py:143-149
    return dpos, np.zeros((T, 1, 3)), np.zeros((T, 1))


def _jax_rollout(cfg=CFG):
    sc = jbench.make(dtype=jnp.float64, **cfg)
    pos0 = _jittered_pos0(sc.state0.pos, (CFG["cloth_N"] + 1) ** 2)
    state0 = jax.tree.map(jnp.asarray, sc.state0.replace(pos=pos0))
    acts = tuple(jnp.asarray(a) for a in _actions())
    _, buf = jax.jit(
        lambda s, a: jstepper.simulate(sc.spec, sc.params, s, a))(state0, acts)
    return pos0, {k: np.asarray(buf[k]) for k in
                  ("pos", "yield_gate", "final_proj_flag", "final_proj_dir")}


def _reference_tree():
    """Every rollout of REFERENCE_CFGS, by name, as its pos0 and buffers."""
    tree = {}
    for name, cfg in REFERENCE_CFGS.items():
        pos0, jbuf = _jax_rollout(cfg)
        tree[name] = dict(pos0=pos0, **jbuf)
    return tree


def _stored_rollout(name):
    """(pos0, buffers) of one rollout, as _jax_rollout returns them."""
    jbuf = _golden.load(REFERENCE)[name]
    return jbuf.pop("pos0"), jbuf


@pytest.fixture(scope="module")
def rollouts():
    pos0, jbuf = _stored_rollout("default")
    sc = bench_scene.make(dtype=torch.float64, **CFG)
    spec, s0, params = sc.to("cpu")
    s0 = s0.replace(pos=torch.as_tensor(pos0))
    stats = {}
    _, tbuf = stepper.simulate(spec, params, s0,
                               tuple(torch.as_tensor(a) for a in _actions()),
                               stats=stats)
    return pos0, jbuf, tbuf, stats


def test_simulate_matches_jax(rollouts):
    _pos0, jbuf, tbuf, stats = rollouts
    assert tbuf["pos"].shape == (T + 1,) + jbuf["pos"].shape[1:]
    np.testing.assert_allclose(tbuf["pos"].numpy(), jbuf["pos"], rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_array_equal(tbuf["yield_gate"].numpy(),
                                  jbuf["yield_gate"])
    np.testing.assert_array_equal(tbuf["final_proj_flag"].numpy(),
                                  jbuf["final_proj_flag"])
    np.testing.assert_array_equal(tbuf["final_proj_dir"].numpy(),
                                  jbuf["final_proj_dir"])
    assert int(jbuf["final_proj_flag"].sum()) > 0, "no contact was made"
    assert stats["newton_iters"] == T * CFG["max_newton_iter"]
    assert stats["hess_builds"] == T and stats["cg_iters"] > 0


@pytest.mark.slow
def test_golden_file_is_current():
    """The saved golden positions, and the rollouts the other tests read,
    are what JAX computes today."""
    want = _reference_tree()
    g = np.load(GOLDEN)
    np.testing.assert_array_equal(g["pos0"], want["default"]["pos0"])
    np.testing.assert_allclose(g["pos"], want["default"]["pos"], rtol=0,
                               atol=1e-12)
    for key in ("cloth_N", "table_n", "max_newton_iter"):
        assert int(g[key]) == CFG[key]
    assert float(g["fwd_tol"]) == CFG["fwd_tol"]
    _golden.assert_current(REFERENCE, want, _assert_entry)


def _assert_entry(key, got, want):
    if key.endswith(".pos"):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=key)
    else:
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_float32_rollout_stays_float32():
    """The bench's working type end to end on the CPU: every buffer stays
    float32 (a float64 leak would make the kernels refuse their inputs on
    the card) and the positions stay finite."""
    sc = bench_scene.make(dtype=torch.float32,
                          **{**CFG, "fwd_tol": 1e-3, "max_newton_iter": 2})
    spec, s0, params = sc.to("cpu")
    acts = tuple(torch.as_tensor(a, dtype=torch.float32)
                 for a in _actions())
    _, buf = stepper.simulate(spec, params, s0, acts)
    for k, v in buf.items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, k
    assert bool(torch.isfinite(buf["pos"]).all())
    assert float(sc.reward(buf)) == -float(
        buf["pos"][-1, :(CFG["cloth_N"] + 1) ** 2, 2].sum())


def test_simulate_requires_a_moved_spec():
    sc = bench_scene.make(dtype=torch.float64, **CFG)
    with pytest.raises(TypeError, match="spec.to"):
        stepper.simulate(sc.spec, sc.params, sc.state0,
                         tuple(torch.as_tensor(a) for a in _actions()))


def test_refresh_one_branch_raises():
    """The hess_refresh=1 branch (full Newton: Hessian, residual and CG
    solve every iteration, an energy-only line search), which raised
    before it was ported, against JAX's on 'cg' through the DIA path."""
    cfg = REFERENCE_CFGS["refresh1"]
    pos0, jbuf = _stored_rollout("refresh1")
    sc = bench_scene.make(dtype=torch.float64, **cfg)
    spec, s0, params = sc.to("cpu")
    assert spec.dia is not None and spec.solver == "cg"
    stats = {}
    _, tbuf = stepper.simulate(spec, params,
                               s0.replace(pos=torch.as_tensor(pos0)),
                               tuple(torch.as_tensor(a) for a in _actions()),
                               stats=stats)
    np.testing.assert_allclose(tbuf["pos"].numpy(), jbuf["pos"], rtol=0,
                               atol=POS_ATOL)
    for key in ("yield_gate", "final_proj_flag", "final_proj_dir"):
        np.testing.assert_array_equal(tbuf[key].numpy(), jbuf[key])
    assert stats["hess_builds"] == stats["newton_iters"] == T * CFG[
        "max_newton_iter"]
    assert stats["cg_iters"] > 0
    assert stats["ls_trials"] >= stats["newton_iters"]


def _write_golden():
    tree = _reference_tree()
    _golden.save(REFERENCE, tree)
    np.savez_compressed(
        GOLDEN, pos0=tree["default"]["pos0"], pos=tree["default"]["pos"],
        cloth_N=CFG["cloth_N"],
        table_n=CFG["table_n"], max_newton_iter=CFG["max_newton_iter"],
        fwd_tol=CFG["fwd_tol"])


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _write_golden()
