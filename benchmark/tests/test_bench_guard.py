"""The guard against JAX, by whole top-level module names."""
import io
import json
import sys
import types
from contextlib import redirect_stderr, redirect_stdout

from benchmark import run
from benchmark.harness.guard import forbidden_modules


def test_top_level_names_compared_whole():
    mods = ["thinshelllab_torch", "thinshelllab_torch.engine.solver",
            "jaxtyping", "jax_cosmo", "numpy", "flax_free"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["jaxlib.xla_client"]) == ["jaxlib"]
    assert forbidden_modules(["thinshelllab_tpu.ops", "flax.linen",
                              "jax"]) == ["flax", "jax",
                                          "thinshelllab_tpu"]


def test_the_harness_and_reference_load_no_jax():
    import benchmark.drivers.trajopt  # noqa: F401
    import benchmark.reference.plain  # noqa: F401
    import benchmark.reference.scenes  # noqa: F401
    assert forbidden_modules() == []


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.finish({"correct": True}, ["check x: 0 (limit 0)"])
    assert rc != 0 and out.getvalue() == ""
    assert "jax" in err.getvalue()


def test_a_clean_run_prints_its_result_last():
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.finish({"correct": True, "checks": {"x": {"value": float(
            "inf"), "limit": 0}}}, ["check x: inf (limit 0)"])
    assert rc == 0
    line = out.getvalue().strip().splitlines()[-1]
    assert json.loads(line)["checks"]["x"]["value"] is None
    assert err.getvalue().strip().splitlines()[-1].startswith("check x")


def test_the_reference_imports_nothing_of_the_program():
    """In a fresh interpreter: the reference's modules load no module of
    thinshelllab_torch (nor JAX)."""
    import subprocess

    code = ("import sys; import benchmark.reference.plain, "
            "benchmark.reference.scenes; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, check=True).stdout
    tops = json.loads(out.strip().replace("'", '"'))
    assert "thinshelllab_torch" not in tops
    assert forbidden_modules(tops) == []
