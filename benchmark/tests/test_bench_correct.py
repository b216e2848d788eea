"""The output check, at tiny sizes on the CPU: a sound run is correct; the
control (the program one precision down) and each fault a cell can have,
planted under the timed path, are not. The look for a card is skipped:
run.execute is the rest of a run.

Faults: a step that returns its state unchanged (Newton returns its
start), and an answer altered where it is produced (the gripper
gradient). The cell has no batch whose half could be left out (a trajopt
iteration is one trajectory) and runs on one card, with no exchange
between cards."""
import time

import pytest

from benchmark import run
from benchmark.harness import manifest

from .conftest import tiny_ctx

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]
# long enough on the CPU for a unit (a trajopt iteration)
SECONDS = 30.0


def _run(workload, **kw):
    man, ctx = tiny_ctx(workload, **kw)
    res, _err = run.execute(ctx, man, SECONDS, time.perf_counter())
    return res


def _over(res):
    """The compared numbers that exceed their limits."""
    return [n for n, v in res["checks"].items()
            if v["value"] is None or v["limit"] is None
            or not v["value"] <= v["limit"]]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert _over(res) == [] and res["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    res = _run(workload, control=True)
    assert _over(res) and not res["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_that_returns_its_state_unchanged(workload, monkeypatch):
    from thinshelllab_torch.engine import solver

    def unchanged(spec, params, pos0, prev_pos, vel, ref_angle, contact,
                  stats=None):
        return pos0

    monkeypatch.setattr(solver, "newton_solve", unchanged)
    res = _run(workload)
    assert _over(res) and not res["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_gradient(workload, monkeypatch):
    from thinshelllab_torch.engine import adjoint

    backward = adjoint.backward

    def altered(*args, **kwargs):
        res = backward(*args, **kwargs)
        return res._replace(gripper_grad=res.gripper_grad * 1.05)

    monkeypatch.setattr(adjoint, "backward", altered)
    res = _run(workload)
    assert "adjoint_gap" in _over(res) and not res["correct"]
