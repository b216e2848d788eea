"""The port's chunked sweeps (the JAX package's API; the port's sweeps
are host loops, so they are the whole sweeps), bit-equal to the whole
ones (the JAX package's tests/test_stepper_chunked.py and
tests/test_adjoint_chunked.py hold its own chunked sweeps to the same): `stepper.simulate_chunked` and
`adjoint.backward_chunked` at chunks of 1 and 3 steps of a T=4 run, and a
`TrajOptDriver(fwd_chunk=2)` iteration, on the CPU in f64.

The scene is the small bench scene of tests/test_torch_adjoint.py
(`cloth_N=8`, CG on its DIA plan with the plain SpMV, GMRES adjoint) at a
Newton cap of 1, the pad pressing 2 mm a step so that the gripper
gradient is not zero; the driver's rollout runs the small folding scene
of tests/test_torch_trajopt.py at a Newton cap of 5 on a seeded waypoint
table.
"""
import dataclasses

import numpy as np
import pytest
import torch

from thinshelllab_torch.engine import adjoint, stepper
from thinshelllab_torch.scenes import bench_scene, folding
from thinshelllab_torch.train.trajopt import TrajOptDriver
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CFG = dict(cloth_N=8, table_n=4, solver="cg", hess_refresh=8,
           max_newton_iter=1, fwd_tol=1e-10, adj_tol=1e-10)
T = 4
# every carry of the sweep in use: parameter gradients, the compensated
# sums, the warm start, the friction seed
BWD = dict(with_param_grad=True, compensated=True, warm_start=True,
           friction_loss=True)


def _equal(a, b, what):
    """Every tensor leaf of a and b (dicts, dataclasses, tensors) equal,
    bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    else:
        assert torch.equal(a, b), what


@pytest.fixture(scope="module")
def bench():
    sc = bench_scene.make(dtype=torch.float64, **CFG)
    spec, s0, params = sc.to("cpu")
    dpos = torch.zeros((T, 1, 3), dtype=torch.float64)
    dpos[:, 0, 2] = -2e-3
    acts = (dpos, torch.zeros_like(dpos), torch.zeros((T, 1),
                                                      dtype=torch.float64))
    stats = {}
    final, buf = stepper.simulate(spec, params, s0, acts, stats=stats,
                                  save_contacts=True)
    res = adjoint.backward(spec, params, buf, *sc.seed_loss(buf), **BWD)
    return sc, spec, s0, params, acts, final, buf, stats, res


@pytest.mark.parametrize("chunk", [1, 3])
def test_simulate_chunked_is_bit_equal(bench, chunk):
    _sc, spec, s0, params, acts, final, buf, stats, _res = bench
    st = {}
    f2, b2 = stepper.simulate_chunked(spec, params, s0, acts, chunk,
                                      stats=st, save_contacts=True)
    _equal(f2, final, "final")
    _equal(b2, buf, "buffers")
    assert st == stats


@pytest.mark.parametrize("chunk", [1, 3])
def test_backward_chunked_is_bit_equal(bench, chunk):
    """The chunked sweep against the whole one (BWD)."""
    sc, spec, _s0, params, _acts, _final, buf, _stats, want = bench
    got = adjoint.backward_chunked(spec, params, buf, *sc.seed_loss(buf),
                                   chunk, **BWD)
    assert float(want.gripper_grad.abs().max()) > 0
    _equal(got.gripper_grad, want.gripper_grad, "gripper_grad")
    _equal(got.pos_grad0, want.pos_grad0, "pos_grad0")
    _equal(got.param_grad, want.param_grad, "param_grad")


def test_chunk_must_be_positive(bench):
    sc, spec, s0, params, acts, _final, buf, _stats, _res = bench
    with pytest.raises(ValueError, match="chunk=0"):
        stepper.simulate_chunked(spec, params, s0, acts, 0)
    with pytest.raises(ValueError, match="chunk=0"):
        adjoint.backward_chunked(spec, params, buf, *sc.seed_loss(buf), 0)


def test_trajopt_fwd_chunk_is_bit_equal():
    """TrajOptDriver(fwd_chunk=2)'s rollout (the only part fwd_chunk
    changes) against the driver's whole one on the same waypoint table:
    the same tape and solver counts, bit for bit."""
    sc = folding.make(table_n=4, max_newton_iter=5, dtype=torch.float64)
    out = []
    for fwd_chunk in (None, 2):
        drv = TrajOptDriver(sc, 4, fwd_chunk=fwd_chunk, device="cpu")
        drv.agent.traj = np.cumsum(np.random.default_rng(0).normal(
            0.0, 3e-4, size=drv.agent.traj.shape), axis=0)
        stats = {}
        out.append((drv.forward(drv.agent.actions(), stats)[1], stats))
    (a, sa), (b, sb) = out
    _equal(b, a, "buffers")
    assert sa == sb and len(sa["newton_per_step"]) == 3
