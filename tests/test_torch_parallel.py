"""The port's `parallel/mesh`, `CMAESDriver(mesh=...)` and entry points
against the JAX package's, in f64 on the CPU over gloo ranks.

The JAX outputs are in tests/data/parallel_golden.npz, made on a 2-device
virtual CPU mesh from the numpy-seeded inputs below:

- `sharded_population_rewards` on 2 ranks equals the port's own
  `batched_rollout_rewards` (rtol 1e-12, as tests/test_parallel.py demands
  of JAX) and JAX's on a 2-device mesh within 1e-9 relative, on
  `folding.make(table_n=4, max_newton_iter=2)` (4 members pressing 0.6 mm a
  step) and on the small bench under cg (2 members, the cloth jittered by
  1e-6 m as in tests/test_torch_stepper.py, for the exact-grid ties);
- `sharded_train_step` on 2 ranks (folding, 2 pressing members, so the
  gripper gradient is not zero): `new_traj` and the loss proxy within 1e-9
  relative of JAX's;
- `CMAESDriver(mesh)` on 2 ranks, pop 4: each member's reward within 1e-9
  relative of the JAX mesh driver's and equal to the mesh-less port
  driver's, and the strategy after tell;
- `batched_rollout` stacks what JAX's vmap stacks;
- `entry(device="cpu")` against JAX's `entry()` in float32, and
  `dryrun_multichip(4, device="cpu")` completes;
- a fresh interpreter imports every module of the port without jax,
  without initialising CUDA and without building an extension.

The launches run in background threads (each rank one torch thread) while
the in-process references run, so the file takes one launch's wall time.

Regenerate the golden file (after a deliberate change of the reference):
    PYTHONPATH=. python tests/test_torch_parallel.py
"""
import concurrent.futures
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from thinshelllab_torch import entry as tentry
from thinshelllab_torch.core.spec import SimState
from thinshelllab_torch.parallel import mesh as pmesh
from thinshelllab_torch.parallel import programs
from thinshelllab_torch.scenes import bench_scene, folding
from thinshelllab_torch.train.cmaes import CMAESDriver
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "parallel_golden.npz")
N_RANKS, T = 2, 2
FOLD_CFG = dict(table_n=4, max_newton_iter=2)
BENCH_CFG = dict(cloth_N=8, table_n=4, solver="cg", max_newton_iter=2,
                 cg_max_iter=40, cg_tol=1e-8)
GEN_CFG = dict(table_n=4, max_newton_iter=5)
GEN_DRIVER = dict(tot_timestep=2, abs_step=2, pop_size=4, seed=0)
B_FOLD, B_BENCH, B_TRAIN, B_ROLLOUT = 4, 2, 2, 2
PRESS_Z = -6e-4  # folding: the pad reaches the cloth at 0.6 mm a step
# sharded against one rank: the same arithmetic on the same members
SINGLE_RTOL = 1e-12
# against the JAX package: dense LU / CG on both sides, sums in another
# order
JAX_RTOL = 1e-9
# entry(): one float32 Newton step (3 iterations) of the folding scene,
# positions ~0.07 m: float32 sums in another order, a few ulps of 0.07 m
ENTRY_ATOL = 1e-6
LAUNCH_TIMEOUT = 240.0  # under the per-test limit of tests/_time_limit.py


def fold_actions(B, seed):
    rng = np.random.default_rng(seed)
    dpos = rng.normal(size=(B, T, 1, 3)) * 1e-4
    dpos[..., 2] += PRESS_Z
    return dpos, np.zeros((B, T, 1, 3)), np.zeros((B, T, 1))


def bench_actions():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(B_BENCH, T, 1, 3)) * 1e-4,
            np.zeros((B_BENCH, T, 1, 3)), np.zeros((B_BENCH, T, 1)))


def bench_pos0(pos0):
    n_cloth = (BENCH_CFG["cloth_N"] + 1) ** 2
    pos0 = np.array(pos0, dtype=np.float64)
    pos0[:n_cloth] += 1e-6 * np.random.default_rng(0).normal(size=(n_cloth,
                                                                   3))
    return pos0


def _bench_scene():
    return bench_scene.make(dtype=torch.float64, **BENCH_CFG)


POP_CASES = {
    "folding": lambda: ("folding", FOLD_CFG, fold_actions(B_FOLD, 3), None),
    "bench": lambda: ("bench", dict(BENCH_CFG, dtype=torch.float64),
                      bench_actions(), bench_pos0(_bench_scene().state0.pos)),
}


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def launches():
    """The module's gloo launches and its fresh interpreter, started in
    background threads: the population, train step and CMA-ES programs in
    one 2-rank launch, dryrun_multichip(4), a launch whose ranks raise,
    and the import-purity child."""
    calls = [(programs.population_rewards, POP_CASES[k]())
             for k in ("folding", "bench")]
    calls += [
        (programs.train_step, ("folding", FOLD_CFG,
                               fold_actions(B_TRAIN, 5),
                               np.zeros((T + 1, 1, 6)))),
        (programs.cmaes_generation, ("folding", GEN_CFG,
                                     dict(GEN_DRIVER, device="cpu"))),
    ]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # one torch thread a rank
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = {
                "ranks": ex.submit(pmesh.launch, programs.sequence, N_RANKS,
                                   "cpu", calls, timeout=LAUNCH_TIMEOUT),
                "dryrun": ex.submit(tentry.dryrun_multichip, 4, "cpu",
                                    LAUNCH_TIMEOUT),
                "failing": ex.submit(failing_launch),
                "purity": ex.submit(purity_child),
            }
            yield futs
            for f in futs.values():
                f.exception()  # every launch ends inside the fixture


def rank_results(launches):
    """The 2-rank launch's results (waits for it): a test computes its
    in-process reference first, while the ranks run."""
    pop_fold, pop_bench, train, gen = launches["ranks"].result()
    return {"folding": pop_fold, "bench": pop_bench, "train": train,
            "cmaes": gen}


@pytest.mark.parametrize("case", list(POP_CASES))
def test_sharded_rewards_match_single_rank(launches, case):
    name, cfg, actions, pos0 = POP_CASES[case]()
    sc, spec, s0, params = programs.scene_on(pmesh.Mesh(device="cpu"), name,
                                             cfg, pos0)
    single = pmesh.batched_rollout_rewards(
        spec, params, s0, programs.as_tensors(actions, spec, "cpu"),
        sc.rewards["default"])
    got = rank_results(launches)[case]
    assert got.shape == (len(actions[0]),) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=SINGLE_RTOL,
                               atol=0)
    assert len(set(got.tolist())) == len(got)  # members differ


@pytest.mark.parametrize("case", list(POP_CASES))
def test_sharded_rewards_match_jax(launches, golden, case):
    got, want = rank_results(launches)[case].numpy(), golden[f"pop.{case}"]
    assert np.all(np.abs(got - want) <= JAX_RTOL * np.abs(want)), (got, want)


def test_sharded_train_step_matches_jax(launches, golden):
    got = rank_results(launches)["train"]
    want_traj = golden["train.new_traj"]
    assert got["new_traj"].shape == want_traj.shape
    assert np.abs(want_traj).max() > 0  # the pads press: a real gradient
    assert rel_err(got["new_traj"], want_traj) <= JAX_RTOL
    assert abs(float(got["loss"]) - float(golden["train.loss"])) <= (
        JAX_RTOL * abs(float(golden["train.loss"])))
    assert got["launches"] == {"dia_spmv": 0, "dia_precond": 0}  # the CPU


def test_cmaes_mesh_generation_matches_jax_and_meshless(launches, golden):
    drv = CMAESDriver(folding.make(**GEN_CFG), device="cpu", **GEN_DRIVER)
    info = drv.generation()
    got = rank_results(launches)["cmaes"]
    want = golden["cmaes.rewards"]
    assert np.all(np.abs(got["rewards"] - want) <= JAX_RTOL * np.abs(want))
    assert np.abs(got["mean"] - golden["cmaes.mean"]).max() <= JAX_RTOL
    assert abs(got["sigma"] - float(golden["cmaes.sigma"])) <= JAX_RTOL
    assert set(info) == set(got) - {"mean", "sigma"}
    np.testing.assert_array_equal(got["rewards"], info["rewards"])
    assert got["stop_steps"] == info["stop_steps"]
    assert got["early"] == info["early"]
    assert got["best_reward"] == info["best_reward"]
    np.testing.assert_array_equal(got["mean"], drv.es.mean)
    assert got["sigma"] == drv.es.sigma


def test_batch_must_split_over_the_mesh():
    sc = folding.make(**GEN_CFG)
    spec, s0, params = sc.to("cpu")
    mesh = pmesh.Mesh(size=2, rank=0, device=torch.device("cpu"))
    acts = programs.as_tensors(fold_actions(3, 0), spec, "cpu")
    with pytest.raises(ValueError, match="does not split"):
        pmesh.sharded_population_rewards(mesh, spec, params, s0, acts,
                                         sc.rewards["default"])
    with pytest.raises(ValueError, match="does not split"):
        pmesh.sharded_train_step(mesh, spec, params, s0, sc.seed_loss, acts,
                                 torch.zeros((T + 1, 1, 6)))
    with pytest.raises(ValueError, match="does not split"):
        CMAESDriver(sc, 2, 2, pop_size=3, mesh=mesh)


def test_batched_rollout_stacks_like_vmap(golden):
    sc = folding.make(**FOLD_CFG)
    spec, s0, params = sc.to("cpu")
    final, tape = pmesh.batched_rollout(
        spec, params, s0,
        programs.as_tensors(fold_actions(B_ROLLOUT, 7), spec, "cpu"))
    assert isinstance(final, SimState) and len(tape) == 7
    assert final.pos.shape == (B_ROLLOUT, spec.NV, 3)
    assert final.gripper.rot.shape == (B_ROLLOUT, 1, 4)
    want = golden["rollout.tape_pos"]
    assert tape[0].shape == want.shape == (B_ROLLOUT, T, spec.NV, 3)
    np.testing.assert_allclose(tape[0].numpy(), want, rtol=0,
                               atol=JAX_RTOL * np.abs(want).max())
    np.testing.assert_array_equal(final.pos.numpy(), tape[0][:, -1].numpy())


def test_entry_matches_jax(golden):
    fn, (state0, action) = tentry.entry(device="cpu")
    out = fn(state0, action)
    want = golden["entry.pos"]
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=ENTRY_ATOL)


def test_dryrun_multichip_cpu(launches):
    out = launches["dryrun"].result()
    assert np.isfinite(out["dense"]) and np.isfinite(out["cg-dia"])


def test_mesh_never_falls_back_to_the_cpu(monkeypatch):
    with pytest.raises(ValueError, match="has 1 rank"):
        pmesh.make_mesh(2, device="cpu")  # no launch: a world of one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pmesh.make_mesh(1),
                 lambda: pmesh.launch(programs.sequence, 2, None, []),
                 lambda: tentry.dryrun_multichip(2),
                 lambda: tentry.entry()):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_make_mesh_joins_a_running_group(tmp_path, monkeypatch):
    """make_mesh joins torchrun's group (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT in the environment) and a group the caller made itself,
    which close() then leaves running."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:  # a free port on localhost
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    mesh = pmesh.make_mesh(1, axis="pop", device="cpu")
    try:
        assert dist.get_backend() == "gloo" and mesh._owned
        assert (mesh.axis_names, mesh.size, mesh.rank) == (("pop",), 1, 0)
        x = torch.arange(3.0)
        assert torch.equal(pmesh.all_gather_blocks(mesh, x), x)
        assert torch.equal(pmesh.pmean(mesh, x), x)
    finally:
        mesh.close()
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(device="cpu")
        assert mesh.size == 1 and not mesh._owned
        mesh.close()
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def failing_launch():
    """A 2-rank launch whose ranks raise (an unknown scene name): the
    exception the launch raised."""
    try:
        pmesh.launch(programs.scene_on, 2, "cpu", "no-such-scene", {},
                     timeout=LAUNCH_TIMEOUT)
    except RuntimeError as e:
        return e
    return None


PURITY_CHILD = textwrap.dedent("""
    import importlib, os, pkgutil, sys
    import thinshelllab_torch
    build = os.path.join(thinshelllab_torch.__path__[0], "_build")
    def built():
        return sorted(os.listdir(build)) if os.path.isdir(build) else []
    before = built()
    for info in pkgutil.walk_packages(thinshelllab_torch.__path__,
                                      "thinshelllab_torch."):
        importlib.import_module(info.name)
    import torch
    from thinshelllab_torch import native
    from thinshelllab_torch.ops import dia_spmv
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m.startswith("thinshelllab_tpu")]
    assert not bad, bad
    assert not torch.cuda.is_initialized()
    assert dia_spmv._lib is None and native._lib is None
    assert built() == before, (before, built())
    print("PURITY_OK", len(sys.modules))
""")


def purity_child():
    return subprocess.run([sys.executable, "-c", PURITY_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_launch_kills_its_ranks_at_its_time_limit():
    import multiprocessing

    before = set(multiprocessing.active_children())  # the module's launches
    with pytest.raises(TimeoutError, match="did not finish within"):
        pmesh.launch(programs.scene_on, 2, "cpu", "folding", {},
                     timeout=0.5)
    assert not set(multiprocessing.active_children()) - before


def test_launch_raises_with_the_rank_traceback(launches):
    err = launches["failing"].result()
    assert err is not None
    assert re.search("rank [01] raised:(.|\n)*KeyError(.|\n)*unknown scene "
                     "'no-such-scene'", str(err)), str(err)


def test_import_purity(launches):
    """A fresh interpreter imports every module of the port: jax and the
    JAX package stay out of sys.modules, CUDA is not initialised, and no
    extension is built or loaded."""
    res = launches["purity"].result()
    assert res.returncode == 0, res.stderr[-4000:]
    assert "PURITY_OK" in res.stdout


def write_golden():
    import importlib.util

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_num_cpu_devices", N_RANKS)
    import jax.numpy as jnp

    from thinshelllab_tpu.parallel import mesh as jmesh
    from thinshelllab_tpu.scenes import bench_scene as jbench
    from thinshelllab_tpu.scenes import folding as jfolding
    from thinshelllab_tpu.train.cmaes import CMAESDriver as JDriver

    def jacts(arrays):
        return tuple(jnp.asarray(a) for a in arrays)

    m = jmesh.make_mesh(N_RANKS)
    out = {}
    sc = jfolding.make(**FOLD_CFG)
    out["pop.folding"] = np.asarray(jmesh.sharded_population_rewards(
        m, sc.spec, sc.params, sc.state0, jacts(fold_actions(B_FOLD, 3)),
        sc.rewards["default"]))
    bsc = jbench.make(dtype=jnp.float64, **BENCH_CFG)
    s0 = bsc.state0.replace(pos=jnp.asarray(bench_pos0(bsc.state0.pos)))
    out["pop.bench"] = np.asarray(jmesh.sharded_population_rewards(
        m, bsc.spec, bsc.params, s0, jacts(bench_actions()),
        bsc.rewards["default"]))
    new_traj, loss = jmesh.sharded_train_step(
        m, sc.spec, sc.params, sc.state0, sc.seed_loss,
        jacts(fold_actions(B_TRAIN, 5)), jnp.zeros((T + 1, 1, 6)))
    out["train.new_traj"], out["train.loss"] = (np.asarray(new_traj),
                                                np.asarray(loss))
    _, tape = jmesh.batched_rollout(sc.spec, sc.params, sc.state0,
                                    jacts(fold_actions(B_ROLLOUT, 7)))
    out["rollout.tape_pos"] = np.asarray(tape[0])
    drv = JDriver(jfolding.make(**GEN_CFG), mesh=m, **GEN_DRIVER)
    drv.generation()
    out["cmaes.rewards"] = -np.asarray(drv.history)
    out["cmaes.mean"], out["cmaes.sigma"] = drv.es.mean, drv.es.sigma
    spec = importlib.util.spec_from_file_location(
        "graft", os.path.join(ROOT, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    fn, args = graft.entry()
    out["entry.pos"] = np.asarray(jax.jit(fn)(*args))
    np.savez(GOLDEN, **out)
    print({k: (v if v.size < 20 else v.shape) for k, v in out.items()})


if __name__ == "__main__":
    write_golden()
