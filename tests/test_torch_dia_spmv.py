"""The two DIA kernels of the port (thinshelllab_torch.ops.dia_spmv).

On the CPU: each kernel's plain PyTorch version against the JAX package's
Pallas kernel in interpret mode and against its XLA einsum, on the small
bench scene's assembled store (f64, rtol 1e-12: the same products summed
in another order), and the wrappers' routes. The CUDA kernels themselves
are held against these plain versions in test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.engine import elements as jelements
from thinshelllab_tpu.engine import solver as jsolver
from thinshelllab_tpu.engine import stepper as jstepper
from thinshelllab_tpu.ops import dia_spmv as jdia
from thinshelllab_tpu.scenes import bench_scene as jbench
from thinshelllab_torch.engine import elements
from thinshelllab_torch.ops import dia_spmv as K
from thinshelllab_torch.scenes import bench_scene
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CFG = dict(cloth_N=8, table_n=4, solver="cg", hess_refresh=8,
           max_newton_iter=4)


@pytest.fixture(scope="module")
def operator():
    """The small bench scene's assembled store and preconditioner inputs,
    built by the JAX package at a perturbed state with contacts, as numpy."""
    sc = jbench.make(dtype=jnp.float64, **CFG)
    spec, params, s0 = sc.spec, sc.params, sc.state0
    rng = np.random.default_rng(0)
    pos = jnp.asarray(s0.pos + 1e-4 * rng.normal(size=s0.pos.shape))

    @jax.jit
    def system(pos):
        contact, _, _ = jstepper.build_contacts(
            spec, params, pos, pos, jnp.asarray(s0.proj_flag),
            jnp.asarray(s0.proj_dir))
        groups = jelements.all_groups(spec, params, pos,
                                      jnp.asarray(s0.ref_angle), contact,
                                      with_hess=True, spd=True)
        st = jsolver.prepare_solver_state(spec, groups, jnp.float64)
        return {"dia": st["dia"], "D": st["D"]}

    st = system(pos)
    plan = spec.dia
    NV, NVp = spec.NV, plan.NVp
    D = np.asarray(st["D"])
    dia = np.asarray(st["dia"])
    dia_pre = dia.copy()
    dia_pre[plan.offsets.index(0), :, :, :NV] = D.transpose(1, 2, 0)
    dinv = np.zeros((3, 3, NVp))
    dinv[:, :, :NV] = np.asarray(jsolver._inv3x3(st["D"])).transpose(1, 2, 0)
    unf2 = np.zeros((3, NVp))
    unf2[:, :NV] = (~spec.frozen).T
    x2 = np.zeros((3, NVp))
    x2[:, :NV] = rng.normal(size=(3, NV))
    return dict(offsets=plan.offsets, dia=dia, dia_pre=dia_pre, dinv=dinv,
                unf2=unf2, x2=x2 * unf2, w=spec.precond_omega,
                sweeps=spec.precond_smooth, NV=NV, NVp=NVp)


def _t(a, device="cpu", dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def test_scene_has_the_bench_plan(operator):
    assert operator["NVp"] == 1024 and len(operator["offsets"]) == 63
    assert operator["sweeps"] == 3 and operator["w"] == 0.8


def test_dia_spmv_plain_matches_pallas_and_einsum(operator):
    op = operator
    offs = op["offsets"]
    want_pl = np.asarray(jdia.dia_spmv(jnp.asarray(op["dia"]),
                                       jnp.asarray(op["x2"]), offs,
                                       interpret=True))
    P = max(abs(o) for o in offs)
    xpad = np.pad(op["x2"], ((0, 0), (P, P)))
    shifted = np.stack([xpad[:, P + o: P + o + op["NVp"]] for o in offs], 1)
    want_xla = np.asarray(jnp.einsum("oijn,jon->in", jnp.asarray(op["dia"]),
                                     jnp.asarray(shifted)))
    got = K.dia_spmv_plain(_t(op["dia"]), _t(op["x2"]), offs).numpy()
    scale = np.abs(want_xla).max()
    np.testing.assert_allclose(got, want_pl, rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(got, want_xla, rtol=1e-12, atol=1e-12 * scale)


def test_dia_precond_plain_matches_pallas(operator):
    op = operator
    r2 = op["x2"][::-1].copy()
    args = (op["dia_pre"], r2, op["unf2"], op["dinv"])
    want = np.asarray(jdia.dia_precond(*(jnp.asarray(a) for a in args),
                                       op["offsets"], op["w"], op["sweeps"],
                                       interpret=True))
    got = K.dia_precond_plain(*(_t(a) for a in args), op["offsets"], op["w"],
                              op["sweeps"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-13 * np.abs(want).max())


def test_wrappers_take_the_plain_version_on_cpu(operator):
    op = operator
    K.reset_launches()
    y = K.dia_spmv(_t(op["dia"]), _t(op["x2"]), op["offsets"])
    z = K.dia_precond(_t(op["dia_pre"]), _t(op["x2"]), _t(op["unf2"]),
                      _t(op["dinv"]), op["offsets"], op["w"], op["sweeps"])
    assert y.shape == z.shape == (3, op["NVp"])
    assert K.LAUNCHES == {"dia_spmv": 0, "dia_precond": 0}


@pytest.mark.parametrize("route,expect", [
    ("auto", False), ("plain", False), ("kernel", ValueError),
    ("bogus", ValueError)])
def test_spmv_route_on_cpu(route, expect):
    sc = bench_scene.make(dtype=torch.float64, spmv=route, **CFG)
    spec = sc.spec.to("cpu")
    x = torch.zeros(3, spec.dia.NVp, dtype=torch.float64)
    if expect is ValueError:
        with pytest.raises(ValueError):
            elements.use_spmv_kernel(spec, x)
    else:
        assert elements.use_spmv_kernel(spec, x) is expect
