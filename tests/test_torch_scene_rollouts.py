"""Every task scene the port added beside folding and bench, at its
published size, against the JAX package's saved run (f64, CPU): a 2-step
rollout with the JAX smoke test's actions (each pad 0.2 mm down a step,
tests/test_scenes.py) and `max_newton_iter=5`, then the backward of the
scene's default seed (with the system-ID parameter's gradient on the
three scenes that have one). Balancing starts from the bundled
pre-grasped state, as `cli trajopt` does.

Tolerances: positions 1e-9 m, `gripper_grad` and `param_grad` 1e-7 of
their largest entry.

Ties (ROADMAP.md §3): sliding, card and interact stack their sheets
exactly eps_contact apart, where `active = gap < eps_contact` is decided
by the last bit, and on pick two pad faces tie in the projection's face
score. XLA's CPU code contracts multiply-adds into FMAs in the projection
and the gap, PyTorch's CPU kernels do not, so the packages decide such
slots differently and their rollouts part (scripts/probe_scene_ties.py).
Those rollout comparisons are strict xfails that name the count; each
runs only up to the step whose positions show the split. Their forward
and backward are held to JAX on the JAX package's own tape, contact sets
included: each step replayed from JAX's state with JAX's contact set.

Regenerate the golden file (after a deliberate change of the reference):
    PYTHONPATH=. python tests/test_torch_scene_rollouts.py
"""
import os

import numpy as np
import pytest
import torch

from thinshelllab_torch.core.convert import (golden_grad_errors,
                                             tape_from_entries)
from thinshelllab_torch.engine import adjoint, stepper
from thinshelllab_torch.scenes import balancing, registry
from thinshelllab_torch.train import dp
from thinshelllab_torch.utils import checkpoint
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "scenes_golden.npz")
SCENES = ["lifting", "sliding", "card", "pick", "forming", "balancing",
          "bouncing", "interact"]
T = 2
MAX_NEWTON = 5
# scene -> (the steps its xfailing rollout runs: the first whose positions
# show the split, the reason), from scripts/probe_scene_ties.py
# --reference and the golden tape; the golden file holds their JAX tape
TIES = {
    "sliding": (1, "36 of 5120 contact slots decided differently at the "
                   "initial state (sheets eps_contact apart; ROADMAP §3)"),
    "card": (2, "20-21 of 2048 contact slots (by the CPU thread count) "
                "decided differently after step 1 (sheets eps_contact "
                "apart; ROADMAP §3)"),
    "pick": (1, "2 active contact slots take the other of two coplanar pad "
                "faces tied in the face score at the initial state "
                "(ROADMAP §3)"),
    "interact": (1, "20 of 3072 contact slots decided differently at the "
                    "initial state (cloth eps_contact above the table; "
                    "ROADMAP §3)"),
}


def smoke_actions(n_part, T=T):
    dpos = np.zeros((T, n_part, 3))
    dpos[:, :, 2] = -0.0002
    return dpos, np.zeros((T, n_part, 3)), np.zeros((T, n_part))


def _rel(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _golden(name):
    g = np.load(GOLDEN)
    pre = name + "."
    return {k[len(pre):]: g[k] for k in g.files if k.startswith(pre)}


def _case(name):
    if name in TIES:
        return pytest.param(name, marks=pytest.mark.xfail(
            strict=True, reason=TIES[name][1]))
    return name


def _scene(name):
    """The scene on the CPU as the golden run built it: (scene, spec,
    state0, params)."""
    sc = registry.make_scene(name, solver="auto", max_newton_iter=MAX_NEWTON)
    if name == "balancing":
        sc.state0 = checkpoint.load_state(balancing.bundled_state_path(),
                                          sc.spec.dtype, "cpu")
    return (sc, *sc.to("cpu"))


def port_run(name, tape=None, steps=T):
    """The port's rollout of `steps` steps and its backward, of one scene
    on the CPU: (buffers, AdjointResult). With `tape` (the JAX package's
    buffers) only the backward runs, on that tape."""
    sc, spec, s0, params = _scene(name)
    if tape is None:
        acts = tuple(torch.as_tensor(a)
                     for a in smoke_actions(sc.n_part, steps))
        _, buf = stepper.simulate(spec, params, s0, acts, save_contacts=True)
    else:
        buf = tape
    res = adjoint.backward(spec, params, buf, *sc.seed_loss(buf),
                           with_param_grad=sc.sys_param is not None)
    return buf, res


def _check_grads(name, res, g):
    """gripper_grad within 1e-7 of its largest entry; every Params leaf's
    gradient within 1e-7 of the largest entry over all leaves, and the
    system-ID parameter's own entry within 1e-7 of itself."""
    gg, pg, sys_rel = golden_grad_errors(
        res, g, registry.make_scene(name).sys_param)
    assert gg < 1e-7 and pg <= 1e-7 and sys_rel <= 1e-7, (gg, pg, sys_rel)


@pytest.mark.parametrize("name", [_case(n) for n in SCENES])
def test_rollout_and_backward_match_jax(name):
    g = _golden(name)
    steps = TIES[name][0] if name in TIES else T
    buf, res = port_run(name, steps=steps)
    np.testing.assert_allclose(buf["pos"].numpy(), g["pos"][:steps + 1],
                               rtol=0, atol=1e-9)
    _check_grads(name, res, g)


@pytest.mark.parametrize("name", sorted(TIES))
def test_forward_on_the_jax_tape(name):
    """A tie scene's forward on the JAX package's own tape: the step whose
    positions show the split, from JAX's state before it, Newton minimising
    with the contact set JAX's step used, within 1e-9 m of JAX's
    positions after it."""
    tape = tape_from_entries(_golden(name))
    sc, spec, s0, params = _scene(name)
    t = TIES[name][0] - 1
    act = tuple(a[t] for a in smoke_actions(sc.n_part))
    pos = stepper.replay_step(spec, params, tape, t, act, s0.vel)
    np.testing.assert_allclose(pos.numpy(), tape["pos"][t + 1].numpy(),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("name", sorted(TIES))
def test_backward_on_the_jax_tape(name):
    """A tie scene's backward, on the JAX package's own tape."""
    g = _golden(name)
    _, res = port_run(name, tape=tape_from_entries(g))
    _check_grads(name, res, g)


# ------------------------------------------------------------ the golden


def _reference(name):
    """The JAX package's run of one scene (the golden file's entries)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from thinshelllab_tpu.engine import adjoint as jadjoint
    from thinshelllab_tpu.engine import stepper as jstepper
    from thinshelllab_tpu.scenes import balancing as jbalancing
    from thinshelllab_tpu.scenes import registry as jregistry
    from thinshelllab_tpu.utils import checkpoint as jcheckpoint

    sc = jregistry.make_scene(name, solver="auto",
                              max_newton_iter=MAX_NEWTON)
    if name == "balancing":
        st = jcheckpoint.load_state(jbalancing.bundled_state_path())
        sc.state0 = jax.tree.map(
            lambda a, b: np.asarray(a, np.asarray(b).dtype), st, sc.state0)
    spec, params = sc.spec, sc.params
    s0 = jax.tree.map(jnp.asarray, sc.state0)
    acts = tuple(jnp.asarray(a) for a in smoke_actions(sc.n_part))
    wpg = sc.sys_param is not None

    def run(s, a):
        _, buf = jstepper.simulate(spec, params, s, a, save_contacts=True)
        res = jadjoint.backward(spec, params, buf, *sc.seed_loss(buf),
                                with_param_grad=wpg)
        return buf, res

    buf, res = jax.jit(run)(s0, acts)
    out = {"pos": np.asarray(buf["pos"]),
           "gripper_grad": np.asarray(res.gripper_grad),
           "reward": np.asarray(sc.reward(buf))}
    if wpg:
        for f in dataclasses.fields(res.param_grad):
            out["param_grad." + f.name] = np.asarray(
                getattr(res.param_grad, f.name))
    if name in TIES:
        for k, v in buf.items():
            if k == "contact":
                for f in dataclasses.fields(v):
                    out["tape.contact." + f.name] = np.asarray(
                        getattr(v, f.name))
            else:
                out["tape." + k] = np.asarray(v)
    return out


def write_golden():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {}
    for name in SCENES:
        for k, v in _reference(name).items():
            out[f"{name}.{k}"] = v
        print(name, "done", flush=True)
    np.savez_compressed(GOLDEN, **out)


if __name__ == "__main__":
    write_golden()
