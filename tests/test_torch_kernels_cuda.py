"""The CUDA kernels of thinshelllab_torch.ops.dia_spmv against their plain
PyTorch versions, on the card (marker `cuda`; each test skips without a
CUDA card).

This file imports no JAX, so that it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py

(--noconftest: tests/conftest.py sets up JAX.) Inputs: the small bench
scene's store assembled by the port at a perturbed state, and a random
store at the full bench plan's shapes (71 offsets, NVp 6144).
"""
import pytest
import torch

from thinshelllab_torch.engine import elements, solver, stepper
from thinshelllab_torch.ops import dia_spmv as K
from thinshelllab_torch.scenes import bench_scene

# kernel vs plain version: the same 9 * n_off products per row summed in
# another order (the kernel adds 8 partial sums per row); f32 keeps ~7
# digits, f64 ~16
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _small_operator(device, dtype):
    sc = bench_scene.make(cloth_N=8, table_n=4, dtype=torch.float64,
                          hess_refresh=8, max_newton_iter=4)
    spec, s0, params = sc.to(device, dtype)
    g = torch.Generator().manual_seed(0)
    pos = s0.pos + 1e-4 * torch.randn(s0.pos.shape, generator=g,
                                      dtype=torch.float64).to(device, dtype)
    contact, _, _ = stepper.build_contacts(spec, params, pos, pos,
                                           s0.proj_flag, s0.proj_dir)
    groups = elements.all_groups(spec, params, pos, s0.ref_angle, contact)
    st = solver.prepare_solver_state(spec, groups, dtype)
    NV, NVp = spec.NV, spec.dia.NVp
    dia_pre = st["dia"].clone()
    dia_pre[spec.dev.off0, :, :, :NV] = st["D"].permute(1, 2, 0)
    dinv = torch.zeros((3, 3, NVp), dtype=dtype, device=device)
    dinv[:, :, :NV] = solver._inv3x3(st["D"]).permute(1, 2, 0)
    return spec.dia.offsets, st["dia"], dia_pre, dinv, spec.dev.unf2


def _bench_shaped_operator(device, dtype):
    plan = bench_scene.make(cloth_N=70, table_n=12).spec.dia
    g = torch.Generator().manual_seed(1)
    NVp, n_off = plan.NVp, len(plan.offsets)
    dia = torch.randn((n_off, 3, 3, NVp), generator=g, dtype=torch.float64)
    dinv = torch.randn((3, 3, NVp), generator=g, dtype=torch.float64) * 0.1
    unf2 = (torch.rand((3, NVp), generator=g) > 0.1).double()
    t = [a.to(device, dtype) for a in (dia, dia, dinv, unf2)]
    return (plan.offsets, *t)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("make", [_small_operator, _bench_shaped_operator],
                         ids=["bench8", "bench70_shapes"])
def test_kernels_match_plain(cuda, dtype, make):
    offs, dia, dia_pre, dinv, unf2 = make(cuda, dtype)
    g = torch.Generator().manual_seed(2)
    x2 = torch.randn(unf2.shape, generator=g, dtype=torch.float64).to(
        cuda, dtype) * unf2
    w, sweeps = 0.8, 3
    K.reset_launches()
    y = K.dia_spmv(dia, x2, offs)
    z = K.dia_precond(dia_pre, x2, unf2, dinv, offs, w, sweeps)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"dia_spmv": 1, "dia_precond": sweeps + 1}
    y_ref = K.dia_spmv_plain(dia, x2, offs)
    z_ref = K.dia_precond_plain(dia_pre, x2, unf2, dinv, offs, w, sweeps)
    for got, ref in ((y, y_ref), (z, z_ref)):
        assert got.dtype == dtype and got.shape == ref.shape
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= RTOL[dtype], err


@pytest.mark.cuda
def test_wrappers_check_their_inputs(cuda):
    offs, dia, dia_pre, dinv, unf2 = _small_operator(cuda, torch.float64)
    x2 = unf2.clone()
    with pytest.raises(ValueError):  # dtype
        K.dia_spmv(dia, x2.float(), offs)
    with pytest.raises(ValueError):  # shape
        K.dia_spmv(dia, x2[:, :512].contiguous(), offs)
    with pytest.raises(ValueError):  # contiguity
        K.dia_spmv(dia.transpose(1, 2), x2, offs)
    with pytest.raises(ValueError):  # device
        K.dia_precond(dia_pre, x2, unf2.cpu(), dinv, offs, 0.8, 3)


@pytest.mark.cuda
def test_bench8_rollout_launches_the_kernels(cuda):
    """The small scene's f64 rollout on the card goes through both kernels
    and matches the same rollout's plain path to the CG tolerance."""
    sc = bench_scene.make(cloth_N=8, table_n=4, dtype=torch.float64,
                          hess_refresh=8, max_newton_iter=4, fwd_tol=1e-10)
    T = 2
    dpos = torch.zeros((T, 1, 3), dtype=torch.float64, device=cuda)
    dpos[:, 0, 2] = -4e-4
    acts = (dpos, torch.zeros_like(dpos), torch.zeros((T, 1), device=cuda,
                                                      dtype=torch.float64))
    spec, s0, params = sc.to(cuda)
    K.reset_launches()
    _, buf = stepper.simulate(spec, params, s0, acts)
    assert K.LAUNCHES["dia_spmv"] > 0 and K.LAUNCHES["dia_precond"] > 0
    K.reset_launches()
    _, ref = stepper.simulate(spec.replace(spmv="plain"), params, s0, acts)
    assert K.LAUNCHES == {"dia_spmv": 0, "dia_precond": 0}
    # CG to 1e-10 of |F| on both paths (metres; the pad moves 8e-4 m)
    assert float((buf["pos"] - ref["pos"]).abs().max()) < 1e-8
