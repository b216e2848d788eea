"""System identification and the CLI's new paths, in f64 on the CPU: one
`ParamOptDriver` iteration and one `ParamCMAESDriver` generation on the
bouncing scene (Kb, no effector) against the JAX package's saved run,
then `cli dp` and `cli trajopt --env balancing` (which starts from the
bundled pre-grasped state) on --platform cpu.

The runs: bouncing at its published size with `max_newton_iter=5`, a
zero (T-1, 0, 3) trajectory as `cli dp` gives it (T=3 for the gradient,
T=2 for CMA-ES with population 3, lr 10).

Regenerate the golden file (after a deliberate change of the reference):
    PYTHONPATH=. python tests/test_torch_dp.py
"""
import os
import re

import numpy as np
import pytest
import torch

from thinshelllab_torch import cli
from thinshelllab_torch.scenes import balancing, registry
from thinshelllab_torch.train.dp import ParamCMAESDriver, ParamOptDriver
from thinshelllab_torch.utils import checkpoint
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "dp_golden.npz")
CFG = dict(max_newton_iter=5)
T_GRAD, T_CMA, LR, POP = 3, 2, 10.0, 3
DP_LINE = re.compile(r"^iter (\d+): reward (-?\d+\.\d{5}) param "
                     r"(-?\d+\.\d{4}) grad (\S+)$")
GEN_LINE = re.compile(r"^gen (\d+): best_param (-?\d+\.\d{4}) "
                      r"best_reward (-?\d+\.\d{5})$")


def zero_actions(T, n_part=0):
    return tuple(np.zeros(s) for s in ((T - 1, n_part, 3),
                                       (T - 1, n_part, 3), (T - 1, n_part)))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def test_param_opt_iteration_matches_jax(golden):
    drv = ParamOptDriver(registry.make_scene("bouncing", **CFG),
                         zero_actions(T_GRAD), lr=LR, device="cpu")
    info = drv.iteration()
    assert abs(info["reward"] - float(golden["reward"])) <= 1e-9
    g = float(golden["grad"])
    assert abs(info["grad"] - g) <= 1e-7 * max(abs(g), 1e-12)
    assert abs(info["param"] - float(golden["param"])) <= 1e-6
    assert 0 < abs(g) <= 1.0  # a real gradient, within the +-1 clip
    assert float(drv.params.kb[0]) == info["param"]
    assert drv.params.kb.device.type == "cpu"


def test_param_cmaes_generation_matches_jax(golden):
    drv = ParamCMAESDriver(registry.make_scene("bouncing", **CFG),
                           zero_actions(T_CMA), base_value=150.0,
                           pop_size=POP, device="cpu")
    info = drv.generation()
    assert abs(info["best_param"] - float(golden["cma_best_param"])) <= 1e-9
    want = float(golden["cma_best_reward"])
    assert abs(info["best_reward"] - want) <= 1e-9 * max(1.0, abs(want))


def test_cli_dp_cpu(capsys):
    cli.main(["dp", "--platform", "cpu", "--env", "bouncing", "--tot_step",
              str(T_CMA), "--iter", "1", "--max_newton_iter", "3"])
    cli.main(["dp", "--platform", "cpu", "--env", "bouncing", "--tot_step",
              str(T_CMA), "--iter", "1", "--max_newton_iter", "3",
              "--method", "cmaes", "--pop_size", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2, lines
    m = DP_LINE.match(lines[0])
    assert m is not None, lines
    assert np.isfinite(float(m.group(2))) and np.isfinite(float(m.group(4)))
    assert GEN_LINE.match(lines[1]) is not None, lines


def test_cli_trajopt_balancing_starts_grasped(tmp_path, capsys,
                                              monkeypatch):
    """`cli trajopt --env balancing` hands TrajOptDriver the bundled
    pre-grasped state (`--load_state none` does not load it); --iter 0
    runs no iteration (the line format is held in test_cli_dp_cpu and
    tests/test_torch_trajopt.py)."""
    from thinshelllab_torch.train import trajopt

    starts = []
    init = trajopt.TrajOptDriver.__init__

    def spy(self, scene, *a, **kw):
        init(self, scene, *a, **kw)
        starts.append(self.state0)

    monkeypatch.setattr(trajopt.TrajOptDriver, "__init__", spy)
    cli.main(["trajopt", "--platform", "cpu", "--env", "balancing",
              "--tot_step", "2", "--iter", "0", "--save_dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["best reward: -inf"], lines
    bundled = checkpoint.load_state(balancing.bundled_state_path(),
                                    torch.float64, "cpu")
    assert torch.equal(starts[0].pos, bundled.pos)
    assert torch.equal(starts[0].gripper.dist, bundled.gripper.dist)
    with pytest.raises(KeyError, match="available"):
        cli.main(["trajopt", "--platform", "cpu", "--env", "nope"])
    args = cli.build_parser().parse_args(
        ["trajopt", "--env", "throwing", "--load_state", "none"])
    assert cli._default_load_state(args) is None
    args = cli.build_parser().parse_args(["trajopt", "--env", "throwing"])
    assert cli._default_load_state(args) == balancing.bundled_state_path()


def write_golden():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from thinshelllab_tpu.scenes import registry as jregistry
    from thinshelllab_tpu.train.dp import (ParamCMAESDriver as JCMA,
                                           ParamOptDriver as JOpt)

    acts = tuple(jnp.asarray(a) for a in zero_actions(T_GRAD))
    info = JOpt(jregistry.make_scene("bouncing", **CFG), acts,
                lr=LR).iteration()
    acts = tuple(jnp.asarray(a) for a in zero_actions(T_CMA))
    cma = JCMA(jregistry.make_scene("bouncing", **CFG), acts,
               base_value=150.0, pop_size=POP).generation()
    np.savez(GOLDEN, reward=info["reward"], param=info["param"],
             grad=info["grad"], cma_best_param=cma["best_param"],
             cma_best_reward=cma["best_reward"])
    print(info, cma)


if __name__ == "__main__":
    write_golden()
