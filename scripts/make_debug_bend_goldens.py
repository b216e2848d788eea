"""Write the JAX package's reference runs that the port's CPU tests
tests/test_torch_debug_utils.py and tests/test_torch_native_bend.py hold
the port against (f64, CPU), and that chip_smoke.py's [debug] phase reads
its state from:

- tests/data/debug_golden.npz: the lifting scene at its golden state
  (tests/data/scenes_golden.npz, lifting.pos[-1]) moved off equilibrium by
  seeded noise of 2e-4 m on its unfrozen rows, as tests/test_collision.py
  does for check_differential; the JAX `contact_forces` and the four
  numbers of `check_differential` there (about 80 s of eager JAX).
- tests/data/bend_batch_golden.npz: a T=2 rollout of
  `bench_scene.make(cloth_N=8, table_n=4, solver="dense")` with
  `bend_batch=True`, the pad pressing 2 mm a step, from the grid jittered
  by 1e-6 m (numpy seed 0) as tests/test_torch_stepper.py does.

    PYTHONPATH=. python scripts/make_debug_bend_goldens.py
"""
import os

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")

# the inputs (the tests read the positions back from the golden files and
# keep their own copy of the configuration and actions)
DEBUG_NOISE = 2e-4
DEBUG_SEED = 1
BEND_CFG = dict(cloth_N=8, table_n=4, solver="dense", max_newton_iter=4)
BEND_T = 2
BEND_DZ = -2e-3


def debug_state_pos(golden_pos, frozen):
    """lifting.pos[-1] plus the seeded noise on the unfrozen rows."""
    rng = np.random.default_rng(DEBUG_SEED)
    noise = rng.standard_normal(golden_pos.shape) * DEBUG_NOISE
    noise[np.asarray(frozen)] = 0.0
    return np.asarray(golden_pos, np.float64) + noise


def bend_pos0(pos0, n_cloth):
    pos0 = np.array(pos0, dtype=np.float64)
    pos0[:n_cloth] += 1e-6 * np.random.default_rng(0).normal(
        size=(n_cloth, 3))
    return pos0


def bend_actions():
    dpos = np.zeros((BEND_T, 1, 3))
    dpos[:, 0, 2] = BEND_DZ
    return dpos, np.zeros((BEND_T, 1, 3)), np.zeros((BEND_T, 1))


def _debug_golden():
    from thinshelllab_tpu.engine.debug import check_differential
    from thinshelllab_tpu.render.debug_plots import contact_forces
    from thinshelllab_tpu.scenes import registry

    sc = registry.make_scene("lifting")
    gold = np.load(os.path.join(DATA, "scenes_golden.npz"))["lifting.pos"][-1]
    pos = debug_state_pos(gold, sc.spec.frozen)
    st = sc.state0.replace(pos=jnp.asarray(pos))
    forces = np.asarray(contact_forces(sc.spec, sc.params, st))
    out = check_differential(sc.spec, sc.params, st, verbose=False)
    np.savez(os.path.join(DATA, "debug_golden.npz"), pos=pos,
             contact_forces=forces, **{k: np.float64(v)
                                       for k, v in out.items()})
    print("debug_golden.npz:", out, "max |force|",
          float(np.abs(forces).max()))


def _bend_golden():
    from thinshelllab_tpu.engine import stepper
    from thinshelllab_tpu.scenes import bench_scene

    sc = bench_scene.make(dtype=jnp.float64, **BEND_CFG)
    spec = sc.spec.replace(bend_batch=True)
    pos0 = bend_pos0(sc.state0.pos, (BEND_CFG["cloth_N"] + 1) ** 2)
    state0 = jax.tree.map(jnp.asarray, sc.state0.replace(pos=pos0))
    acts = tuple(jnp.asarray(a) for a in bend_actions())
    _, buf = jax.jit(lambda s, a: stepper.simulate(spec, sc.params, s, a))(
        state0, acts)
    pos = np.asarray(buf["pos"])
    np.savez(os.path.join(DATA, "bend_batch_golden.npz"), pos=pos)
    print("bend_batch_golden.npz: max |dpos|",
          float(np.abs(pos[-1] - pos[0]).max()))


if __name__ == "__main__":
    _bend_golden()
    _debug_golden()
