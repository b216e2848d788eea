"""The port's trajectory optimisation against the JAX package's, in f64
on the CPU: the waypoint agent (actions, the motion-limit projection, the
warm starts), Adam across its lr decay, two TrajOptDriver iterations on
the small folding scene, and `cli trajopt`; and the saved golden file that
chip_smoke.py holds the CUDA run against.

The small scene is `folding.make(table_n=4, max_newton_iter=30)` (see
tests/test_torch_folding.py) with a T=5 waypoint table, lr 1e-3 and
max_dist 0.015; the table starts at zero, as the CLI's does.

The tests read the JAX TrajOptDriver's run from the golden file; only
test_golden_file_is_current (marked slow) runs it, and holds the file, and
tests/test_torch_folding.py's reference on the same scene, to what the JAX
package computes today.

Regenerate the golden file (after a deliberate change of the reference),
with one OpenBLAS thread as the tests run:
    OPENBLAS_NUM_THREADS=1 PYTHONPATH=. python tests/test_torch_trajopt.py
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.agent.traj_opt import TrajAgent as JTrajAgent
from thinshelllab_tpu.optim.adam import Adam as JAdam
from thinshelllab_tpu.scenes import folding as jfolding
from thinshelllab_tpu.scenes import registry as jregistry
from thinshelllab_tpu.train.trajopt import TrajOptDriver as JTrajOptDriver
from thinshelllab_torch import cli
from thinshelllab_torch.agent.traj_opt import TrajAgent
from thinshelllab_torch.core.convert import (adam_state_from_reference,
                                             traj_agent_from_reference)
from thinshelllab_torch.optim.adam import Adam
from thinshelllab_torch.scenes import folding, registry
from thinshelllab_torch.train.trajopt import TrajOptDriver
import _golden
import test_torch_folding
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "folding_trajopt_golden.npz")
CFG = dict(table_n=4, max_newton_iter=30)
T = 5
LR, MAX_DIST = 1e-3, 0.015
N_ITERS = 2
# the JAX CLI's progress line, `iter i: reward ... |g| ... t ...s`
LINE = re.compile(r"^iter (\d+): reward (-?\d+\.\d{6}) \|g\| (\S+) "
                  r"t (\d+\.\d{2})s$")


def _rel(got, want):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale > 0 else 1.0)


def _seeded_table(n_part, steps=12, seed=0):
    rng = np.random.default_rng(seed)
    traj = np.cumsum(rng.normal(0.0, 8e-4, size=(steps, n_part, 6)), axis=0)
    traj[0] = 0.0
    return traj


def test_agent_actions_and_motion_limit_match_jax():
    """Actions of a seeded table, then the sequential projection: exact."""
    ja = JTrajAgent(12, 2, max_moving_dist=0.001)
    ja.traj = _seeded_table(2)
    a = traj_agent_from_reference(ja)
    for got, want in zip(a.actions(), ja.actions()):
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ja.fix_action(MAX_DIST)
    a.fix_action(MAX_DIST)
    np.testing.assert_array_equal(a.traj, ja.traj)
    assert a.calculate_dist(3, MAX_DIST, 1) == ja.calculate_dist(3, MAX_DIST,
                                                                  1)


@pytest.mark.parametrize("name", ["forming", "pick_fold", "card", "slide"])
def test_init_traj_matches_jax(name, tmp_path):
    ja, a = JTrajAgent(60, 2), TrajAgent(60, 2)
    getattr(ja, f"init_traj_{name}")()
    getattr(a, f"init_traj_{name}")()
    np.testing.assert_array_equal(a.traj, ja.traj)
    path = os.path.join(tmp_path, "traj.npy")
    a.save(path)
    b = TrajAgent(60, 2)
    b.load(path)
    np.testing.assert_array_equal(b.traj, ja.traj)


def test_adam_matches_jax():
    """12 steps across the x0.9 lr decay at step 10: 5 in JAX, the state
    carried over, 7 more in each. The gradients are float32, as an f32
    scene's backward gives them; the state stays float64."""
    rng = np.random.default_rng(2)
    shape = (T, 1, 6)
    grads = rng.normal(0.0, 1.0, size=(12,) + shape).astype(np.float32)
    ja, a = JAdam(shape, LR), Adam(shape, LR)
    js, jp = ja.init(), jnp.asarray(rng.normal(size=shape))
    for g in grads[:5]:
        js, jp = ja.step(js, jp, jnp.asarray(g))
    st, p = adam_state_from_reference(js), torch.as_tensor(np.array(jp))
    for g in grads[5:]:
        js, jp = ja.step(js, jp, jnp.asarray(g))
        st, p = a.step(st, p, torch.as_tensor(g))
    assert p.dtype == torch.float64
    assert _rel(p, jp) < 1e-12
    for got, want in zip(st, js):
        assert _rel(got, want) < 1e-12
    assert float(st.it) == 12.0 and abs(float(st.lr) - 0.9 * LR) < 1e-18


def _reference():
    """The JAX driver's two iterations and its first iteration's tape and
    gradient, as the golden file holds them."""
    sc = jfolding.make(**CFG)
    drv = JTrajOptDriver(sc, T, lr=LR, max_dist=MAX_DIST)
    _, buf = drv._forward(drv.agent.actions())
    res = drv._backward(buf, *sc.seed_loss(buf))
    norms = [drv.iteration()["grad_norm"] for _ in range(N_ITERS)]
    return dict(pos=np.asarray(buf["pos"]),
                ref_angle=np.asarray(buf["ref_angle"]),
                yield_gate=np.asarray(buf["yield_gate"]),
                gripper_grad=np.asarray(res.gripper_grad),
                rewards=np.asarray(drv.history), grad_norms=np.asarray(norms),
                traj=np.array(drv.agent.traj),
                table_n=CFG["table_n"], max_newton_iter=CFG["max_newton_iter"],
                T=T, lr=LR, max_dist=MAX_DIST)


@pytest.fixture(scope="module")
def ref():
    with np.load(GOLDEN) as g:
        return dict(g)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    save_dir = str(tmp_path_factory.mktemp("trajopt"))
    drv = TrajOptDriver(folding.make(**CFG), T, lr=LR, max_dist=MAX_DIST,
                        save_dir=save_dir, device="cpu")
    infos = [drv.iteration() for _ in range(N_ITERS)]
    return drv, infos, save_dir


def test_driver_iterations_match_jax(port, ref):
    drv, infos, save_dir = port
    buf = infos[0]["buffers"]
    np.testing.assert_allclose(buf["pos"].numpy(), ref["pos"], rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(buf["yield_gate"].numpy(),
                                  ref["yield_gate"])
    assert _rel(infos[0]["gripper_grad"], ref["gripper_grad"]) < 1e-7
    assert _rel(np.asarray(drv.history), ref["rewards"]) < 1e-9
    assert _rel(np.asarray([i["grad_norm"] for i in infos]),
                ref["grad_norms"]) < 1e-7
    np.testing.assert_allclose(drv.agent.traj, ref["traj"], rtol=0,
                               atol=1e-10)
    assert min(ref["grad_norms"]) > 0
    assert np.abs(ref["traj"]).max() > 0
    np.testing.assert_array_equal(
        np.load(os.path.join(save_dir, "plot_data.npy")), drv.history)
    best = int(np.argmax(drv.history))
    assert drv.best_reward == drv.history[best]
    assert os.path.exists(os.path.join(save_dir, "best_traj.npy"))
    for info in infos:
        assert info["stats"]["newton_iters"] == sum(
            info["stats"]["newton_per_step"])
        assert info["forward_s"] > 0 and info["backward_s"] > 0


@pytest.mark.slow
@pytest.mark.timeout(900)
def test_golden_file_is_current():
    """The saved golden run, and test_torch_folding's reference, are what
    JAX computes today."""
    ref = _reference()
    g = np.load(GOLDEN)
    for key in ("pos", "ref_angle", "gripper_grad", "rewards", "grad_norms",
                "traj"):
        np.testing.assert_allclose(g[key], ref[key], rtol=0, atol=1e-12,
                                   err_msg=key)
    np.testing.assert_array_equal(g["yield_gate"], ref["yield_gate"])
    for key in ("table_n", "max_newton_iter", "T"):
        assert int(g[key]) == ref[key]
    assert (float(g["lr"]), float(g["max_dist"])) == (LR, MAX_DIST)
    # test_torch_folding's reference, on the same scene
    assert test_torch_folding.CFG == CFG
    _golden.assert_current(test_torch_folding.REFERENCE,
                           test_torch_folding._reference(),
                           test_torch_folding.assert_reference_entry)


def test_cli_trajopt_cpu_full_size(tmp_path, capsys):
    """The published scene for 2 steps on the CPU (dense, f64): the JAX
    CLI's line format, a finite reward, the saved files."""
    cli.main(["trajopt", "--platform", "cpu", "--env", "folding",
              "--tot_step", "3", "--iter", "1", "--save_dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    m = LINE.match(lines[0])
    assert m is not None, lines
    assert m.group(1) == "0" and np.isfinite(float(m.group(2)))
    assert np.isfinite(float(m.group(3)))
    assert lines[1].startswith("best reward: ")
    assert np.load(os.path.join(tmp_path, "best_traj.npy")).shape == (3, 1, 6)


def test_cli_platform_defaults():
    """The JAX CLI's defaults: on the card 'auto' (which resolves to the
    dense solve at folding's 1506 DOF) and float32; on the CPU dense and
    the scene's float64. The scene is built on the host either way."""
    ap = cli.build_parser()
    card = cli._make_scene(ap.parse_args(["trajopt"]), torch.device("cuda"))
    assert (card.spec.solver, card.spec.dtype) == ("dense", torch.float32)
    assert card.spec.NV == 502
    f64 = cli._make_scene(ap.parse_args(["trajopt", "--f64"]),
                          torch.device("cuda"))
    assert f64.spec.dtype == torch.float64
    cpu = cli._make_scene(ap.parse_args(["trajopt", "--platform", "cpu"]),
                          torch.device("cpu"))
    assert (cpu.spec.solver, cpu.spec.dtype) == ("dense", torch.float64)
    cpu32 = cli._make_scene(ap.parse_args(["trajopt", "--platform", "cpu",
                                           "--f32"]), torch.device("cpu"))
    assert cpu32.spec.dtype == torch.float32


def test_cli_unknown_env_raises_the_listing():
    with pytest.raises(KeyError) as jerr:
        jregistry.make_scene("nope")
    with pytest.raises(KeyError, match=r"unknown scene 'nope'; available: "
                       r"\['balance', 'balancing', 'bench', 'bouncing', "
                       r"'card', 'folding', 'forming', 'interact', "
                       r"'lifting', 'pick', 'pick_fold', 'separating', "
                       r"'sliding', 'throwing'\]") as err:
        cli.main(["trajopt", "--platform", "cpu", "--env", "nope"])
    assert str(err.value) == str(jerr.value)
    assert sorted(registry.SCENES) == sorted(jregistry.SCENES)


def test_cli_unported_options_raise(tmp_path, capsys):
    """Without a card the default platform raises; --render_every (once
    unported) renders the rollout; --fwd_chunk (once unported) gives the
    line of the whole rollout: the published scene for 3 steps on the
    CPU, in segments of 2 steps and in one."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli.main(["trajopt", "--env", "folding", "--iter", "1"])
        with pytest.raises(RuntimeError, match="no CUDA card"):
            TrajOptDriver(folding.make(**CFG), T)
    base = ["trajopt", "--platform", "cpu", "--iter", "1"]
    capsys.readouterr()
    got = []
    for extra in (["--render_every", "1"], ["--fwd_chunk", "2"]):
        cli.main(base + ["--env", "folding", "--tot_step", "3",
                         "--save_dir", str(tmp_path)] + extra)
        m = LINE.match(capsys.readouterr().out.strip().splitlines()[0])
        assert m is not None
        got.append(m.group(2, 3))
    assert got[0] == got[1] and np.isfinite(float(got[0][0]))
    assert {"0.png", "1.png", "2.png", "GIF_0.gif"} <= set(
        os.listdir(tmp_path))


def _write_golden():
    np.savez_compressed(GOLDEN, **_reference())


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    _write_golden()
