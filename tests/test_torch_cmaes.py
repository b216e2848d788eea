"""The port's CMA-ES policy search against the JAX package's, in f64 on the
CPU: the early-stop accounting on a rollout tape, one `CMAESDriver`
generation, and `cli cmaes`; the saved golden file is the one chip_smoke.py
holds the CUDA run against.

- `rollout_stop_step` on the JAX package's rammed-pad tape
  (tests/test_training.py's set-up: `folding.make(table_n=4,
  max_newton_iter=4)`, T=8, the pad driven 2.5 mm down a step): the stop
  step and the early flag equal JAX's, and equal to the port's own serial
  `check_early_stop` replay of the tape.
- One generation on `folding.make(table_n=4, max_newton_iter=5)`, pop 4,
  tot_step 2, abs_step 2, seed 0: each member's reward within 1e-9
  relative of JAX's, stop steps and early flags equal, the strategy's mean
  and sigma after `tell` within 1e-9.
- A JAX driver carried across (`convert.cmaes_driver_from_reference`):
  its next ask and best agent equal JAX's; onto a port mesh, it takes the
  mesh's device.

Regenerate the golden file (after a deliberate change of the reference):
    PYTHONPATH=. python tests/test_torch_cmaes.py
"""
import os

import numpy as np
import pytest
import torch

from thinshelllab_torch import cli
from thinshelllab_torch.core.convert import buffers_from_reference
from thinshelllab_torch.scenes import folding
from thinshelllab_torch.scenes.base import check_early_stop
from thinshelllab_torch.train.cmaes import (CMAESDriver, rollout_stop_step,
                                            tape_state)
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "cmaes_golden.npz")
RAM_CFG = dict(table_n=4, max_newton_iter=4)
RAM_T, RAM_DZ = 8, -2.5e-3
GEN_CFG = dict(table_n=4, max_newton_iter=5)
POP, TOT, ABS, SEED = 4, 2, 2, 0
REWARD_RTOL = 1e-9
ES_TOL = 1e-9
TAPE_KEYS = ("pos", "ref_angle", "gripper_pos", "gripper_rot",
             "gripper_dist", "pad_local", "final_proj_flag",
             "final_proj_dir")


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def rammed_actions(n_part):
    dpos = np.zeros((RAM_T, n_part, 3))
    dpos[:, :, 2] = RAM_DZ
    return dpos, np.zeros((RAM_T, n_part, 3)), np.zeros((RAM_T, n_part))


def test_rollout_stop_step_on_the_jax_tape(golden):
    spec, _, params = folding.make(**RAM_CFG).to("cpu")
    tape = buffers_from_reference({k: golden["ram." + k] for k in TAPE_KEYS})
    stop_step, early = rollout_stop_step(spec, params, tape)
    assert early and bool(golden["ram.early"])
    assert stop_step == int(golden["ram.stop_step"])
    assert 0 < stop_step < RAM_T + 1
    first_bad = next(t for t in range(RAM_T + 1) if bool(check_early_stop(
        spec, params, tape_state(tape, t), frame=t)))
    assert stop_step == first_bad


def test_cmaes_generation_matches_jax(golden):
    drv = CMAESDriver(folding.make(**GEN_CFG), TOT, ABS, pop_size=POP,
                      seed=SEED, device="cpu")
    info = drv.generation()
    want = golden["gen.rewards"]
    assert np.all(np.abs(info["rewards"] - want)
                  <= REWARD_RTOL * np.abs(want)), (info["rewards"], want)
    assert info["stop_steps"] == golden["gen.stop_steps"].tolist()
    assert info["early"] == golden["gen.early"].tolist()
    assert np.abs(drv.es.mean - golden["gen.mean"]).max() <= ES_TOL
    assert abs(drv.es.sigma - float(golden["gen.sigma"])) <= ES_TOL
    assert drv.history == (-info["rewards"]).tolist()
    agent = drv.best_agent()
    assert agent.traj.shape == (TOT, 1, 6)
    np.testing.assert_allclose(agent.traj, golden["gen.best_traj"],
                               rtol=0, atol=1e-15)


def test_driver_carried_from_jax():
    """cmaes_driver_from_reference: a JAX driver's settings, history and
    strategy state (after a few synthetic generations), so the next ask
    is JAX's."""
    from thinshelllab_tpu.scenes import folding as jfolding
    from thinshelllab_tpu.train.cmaes import CMAESDriver as JDriver
    from thinshelllab_torch.core.convert import cmaes_driver_from_reference
    from thinshelllab_torch.parallel.mesh import Mesh

    jdrv = JDriver(jfolding.make(**GEN_CFG), 6, 3, pop_size=5, sigma=0.7,
                   seed=4, skip_first=2)
    for g in range(3):
        X = jdrv.es.ask()
        f = np.sum((X - 4.0) ** 2, axis=1)
        jdrv.es.tell(X, f)
        jdrv.history.extend(f.tolist())
    drv = cmaes_driver_from_reference(jdrv, folding.make(**GEN_CFG))
    assert (drv.tot_timestep, drv.abs_step, drv.pop_size, drv.skip_first,
            drv.seed) == (6, 3, 5, 2, 4)
    assert drv.history == jdrv.history and drv.device.type == "cpu"
    np.testing.assert_array_equal(drv.es.C, jdrv.es.C)
    np.testing.assert_array_equal(drv.es.ask(), jdrv.es.ask())
    np.testing.assert_array_equal(drv.best_agent().traj,
                                  jdrv.best_agent().traj)
    mesh = Mesh(size=5, rank=4, device=torch.device("cpu"))
    on_mesh = cmaes_driver_from_reference(jdrv, folding.make(**GEN_CFG),
                                          device="cuda", mesh=mesh)
    assert on_mesh.mesh is mesh and on_mesh.device == mesh.device


def test_driver_rejects_a_mesh():
    """A mesh is a parallel.mesh.Mesh over which the population splits
    evenly, on the driver's device (tests/test_torch_parallel.py runs the
    sharded generation)."""
    from thinshelllab_torch.parallel.mesh import Mesh

    with pytest.raises(TypeError, match="mesh"):
        CMAESDriver(folding.make(**GEN_CFG), TOT, ABS, mesh=object(),
                    device="cpu")
    cpu2 = Mesh(size=2, rank=1, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split"):
        CMAESDriver(folding.make(**GEN_CFG), TOT, ABS, pop_size=5, mesh=cpu2)
    with pytest.raises(ValueError, match="not the mesh's"):
        CMAESDriver(folding.make(**GEN_CFG), TOT, ABS, mesh=cpu2,
                    device="cuda")


def test_cli_cmaes_cpu(tmp_path, capsys, monkeypatch):
    cli.main(["cmaes", "--platform", "cpu", "--env", "folding", "--tot_step",
              "2", "--abs_step", "2", "--pop_size", "2", "--iter", "1",
              "--max_newton_iter", "2", "--save_dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("gen 0: best "), lines
    assert np.isfinite(float(lines[0].split()[3]))
    assert np.load(tmp_path / "traj_0.npy").shape == (2, 1, 6)
    assert np.load(tmp_path / "plot_data.npy").shape == (2,)
    assert (tmp_path / "plot.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    # no card and no --platform cpu: raises, nothing falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["cmaes", "--env", "folding", "--iter", "1"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CMAESDriver(folding.make(**GEN_CFG), TOT, ABS)


def write_golden():
    import copy

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from thinshelllab_tpu.engine import stepper
    from thinshelllab_tpu.scenes import folding as jfolding
    from thinshelllab_tpu.train.cmaes import (CMAESDriver as JDriver,
                                              decode_genome,
                                              rollout_stop_step as jstop)

    out = {}
    sc = jfolding.make(**RAM_CFG)
    acts = tuple(jnp.asarray(a) for a in rammed_actions(sc.n_part))
    _, buf = stepper.simulate(sc.spec, sc.params, sc.state0, acts)
    stop, early = jstop(sc.spec, sc.params, buf)
    out.update({"ram." + k: np.asarray(buf[k]) for k in TAPE_KEYS})
    out["ram.stop_step"], out["ram.early"] = int(stop), bool(early)

    sc = jfolding.make(**GEN_CFG)
    drv = JDriver(sc, TOT, ABS, pop_size=POP, seed=SEED)
    X = copy.deepcopy(drv.es).ask()
    drv.generation()
    stops, earlies = [], []
    for x in X:
        a = decode_genome(x, TOT, ABS, sc.n_part).actions()
        _, buf = stepper.simulate(sc.spec, sc.params, sc.state0, a)
        s, e = jstop(sc.spec, sc.params, buf)
        stops.append(int(s))
        earlies.append(bool(e))
    out["gen.rewards"] = -np.asarray(drv.history)
    out["gen.stop_steps"] = np.asarray(stops)
    out["gen.early"] = np.asarray(earlies)
    out["gen.mean"] = drv.es.mean
    out["gen.sigma"] = drv.es.sigma
    out["gen.best_traj"] = drv.best_agent().traj
    np.savez(GOLDEN, **out)
    print({k: v for k, v in out.items() if not k.startswith("ram.")
           or k in ("ram.stop_step", "ram.early")})


if __name__ == "__main__":
    write_golden()
