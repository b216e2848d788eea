"""The port's task API against the live JAX functions, in f64 on the CPU:
`effector_total_forces`, `check_early_stop`, `observation` and
`force_loss_pos_grad` on every registry scene with a gripper (its
published size, the bench scene in f64, carried from the JAX build with
`convert.from_reference`),
each on the initial state and on two seeded perturbations of it, a small
one (positions 0.1 mm, velocities 1 mm/s) and a large one (positions 2
mm, which pushes the pads past the 10 N bound); `decode_genome` on seeded
genomes; `TrajAgent.apply_grad`; `save_reward_curve` (the JAX package's
figure with matplotlib, a plain chart without it) and the trajopt driver's
`plot.png`.

Tolerances: forces and position gradients 1e-12 of their largest entry
(or absolute below 1), observations 1e-12 m, early-stop flags and the
decoded waypoint tables equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from thinshelllab_tpu.agent.traj_opt import TrajAgent as JTrajAgent
from thinshelllab_tpu.scenes import base as jbase
from thinshelllab_tpu.scenes import registry as jregistry
from thinshelllab_tpu.train.cmaes import decode_genome as jdecode
from thinshelllab_tpu.utils.plotting import save_reward_curve as jcurve
from thinshelllab_torch.agent.traj_opt import TrajAgent
from thinshelllab_torch.core.convert import from_reference
from thinshelllab_torch.scenes import base, folding
from thinshelllab_torch.train.cmaes import decode_genome
from thinshelllab_torch.train.trajopt import TrajOptDriver
from thinshelllab_torch.utils import plotting
from thinshelllab_torch.utils.plotting import save_reward_curve
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GRIPPER_SCENES = ["folding", "lifting", "sliding", "card", "pick", "forming",
                  "balancing", "interact", "bench"]
TOL = 1e-12
# (state, frame, rl) cases of the early-stop test: contact lost after frame
# 10 fires on the resting state only outside RL; the large perturbation
# trips the force bound
EARLY_CASES = [(0, 5, False), (0, 20, False), (0, 20, True), (1, 20, True),
               (2, 5, True)]


def _rel(got, want):
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.fixture(scope="module", params=GRIPPER_SCENES)
def pair(request):
    """(JAX scene, its jitted task functions, the port's spec and params
    on the CPU, the three states of both packages)."""
    kw = {"dtype": jnp.float64} if request.param == "bench" else {}
    jsc = jregistry.make_scene(request.param, **kw)
    P = jax.tree.map(jnp.asarray, jsc.params)
    s0 = jax.tree.map(jnp.asarray, jsc.state0)
    rng = np.random.default_rng(1)
    shape = s0.pos.shape
    states = [s0]
    for dp, dv in ((1e-4, 1e-3), (2e-3, 0.0)):
        states.append(dataclasses.replace(
            s0, pos=s0.pos + rng.normal(0.0, dp, shape),
            vel=s0.vel + rng.normal(0.0, dv, shape)))
    fns = dict(
        forces=jax.jit(lambda st: jbase.effector_total_forces(jsc.spec, P,
                                                              st)),
        early=jax.jit(lambda st, fr, rl: jbase.check_early_stop(
            jsc.spec, P, st, fr, rl), static_argnums=2),
        grad=jax.jit(lambda p, gf: jbase.force_loss_pos_grad(jsc.spec, P, p,
                                                             gf)),
    )
    spec = from_reference(jsc.spec).to("cpu")
    params = from_reference(jsc.params).to("cpu")
    pstates = [from_reference(s).to("cpu") for s in states]
    return jsc, fns, spec, params, states, pstates


def test_effector_total_forces(pair):
    jsc, fns, spec, params, states, pstates = pair
    for js, ps in zip(states, pstates):
        want = fns["forces"](js)
        assert want.shape == (jsc.n_part, 3)
        assert _rel(base.effector_total_forces(spec, params, ps),
                    want) <= TOL
    # the large perturbation reaches the 10 N bound
    assert np.abs(np.asarray(fns["forces"](states[2]))).max() > 10.0


def test_check_early_stop(pair):
    _, fns, spec, params, states, pstates = pair
    got = [bool(base.check_early_stop(spec, params, pstates[i], fr, rl))
           for i, fr, rl in EARLY_CASES]
    want = [bool(fns["early"](states[i], fr, rl)) for i, fr, rl in EARLY_CASES]
    assert got == want
    assert want[2:] == [False, False, True]


def test_observation(pair):
    jsc, _, spec, _, states, pstates = pair
    for js, ps in zip(states, pstates):
        want = np.asarray(jbase.observation(jsc.spec, js))
        got = base.observation(spec, ps).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL


def test_force_loss_pos_grad(pair):
    jsc, fns, spec, params, states, pstates = pair
    gf = np.random.default_rng(2).normal(size=(jsc.n_part, 3))
    for js, ps in zip(states[:2], pstates[:2]):
        want = fns["grad"](js.pos, jnp.asarray(gf))
        got = base.force_loss_pos_grad(spec, params, ps.pos, gf)
        assert np.abs(np.asarray(want)).max() > 0
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("tot,abs_step,n_part,skip", [(2, 2, 1, 0),
                                                      (12, 4, 2, 0),
                                                      (10, 3, 1, 5)])
def test_decode_genome(tot, abs_step, n_part, skip):
    rng = np.random.default_rng(tot)
    for sigma in (1.0, 4.0):
        x = 5.0 + sigma * rng.standard_normal(abs_step * 6 * n_part)
        for max_dist in (0.015, 0.002):
            want = jdecode(x, tot, abs_step, n_part, max_dist=max_dist,
                           skip_first=skip)
            got = decode_genome(x, tot, abs_step, n_part, max_dist=max_dist,
                                skip_first=skip)
            np.testing.assert_array_equal(got.traj, want.traj)
            a = got.actions()
            assert a[0].shape == (tot - 1, n_part, 3)


def test_apply_grad():
    rng = np.random.default_rng(3)
    traj = rng.normal(0.0, 1e-3, (6, 2, 6))
    grad = rng.normal(size=traj.shape)
    want, got = JTrajAgent(6, 2), TrajAgent(6, 2)
    want.traj, got.traj = traj.copy(), traj.copy()
    want.apply_grad(lambda t: t - 1e-3 * jnp.asarray(grad) * t**2)
    got.apply_grad(lambda t: t - 1e-3 * torch.as_tensor(grad) * t**2)
    assert got.traj.dtype == np.float64
    assert np.abs(got.traj - want.traj).max() <= 1e-18


def test_reward_curves(tmp_path, monkeypatch):
    history = [-0.3, -0.25, -0.21, -0.22, -0.1]
    a = jcurve(str(tmp_path / "jax" / "plot.png"), history)
    b = save_reward_curve(str(tmp_path / "port" / "plot.png"), history)
    np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                  np.asarray(Image.open(b)))

    # without matplotlib (the card's image has none): a plain PNG chart
    # of the same history
    monkeypatch.setattr(plotting, "plt", None)
    c = save_reward_curve(str(tmp_path / "plain" / "plot.png"), history)
    img = np.asarray(Image.open(c))
    assert img.shape == (480, 640, 3)
    blue = np.all(img == plotting._BLUE, axis=2)
    assert blue.any() and not blue[:, :48].any()
    assert np.asarray(Image.open(save_reward_curve(
        str(tmp_path / "plain1.png"), [0.5]))).shape == (480, 640, 3)
    monkeypatch.undo()

    drv = TrajOptDriver(folding.make(table_n=4, max_newton_iter=3), 2,
                        save_dir=str(tmp_path / "trajopt"), device="cpu")
    drv.iteration()
    drv.iteration()
    d = tmp_path / "trajopt"
    assert sorted(p.name for p in d.iterdir()) == [
        "best_traj.npy", "plot.png", "plot_data.npy"]
    assert np.load(d / "plot_data.npy").shape == (2,)
    c = jcurve(str(tmp_path / "jax2" / "plot.png"), drv.history)
    np.testing.assert_array_equal(np.asarray(Image.open(d / "plot.png")),
                                  np.asarray(Image.open(c)))
