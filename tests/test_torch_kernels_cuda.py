"""The CUDA kernels of thinshelllab_torch.ops.dia_spmv against their plain
PyTorch versions, on the card (marker `cuda`; each test skips without a
CUDA card).

This file imports no JAX, so that it runs on a machine without it:

    python3 -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py

(--noconftest: tests/conftest.py sets up JAX.) Inputs: the small bench
scene's store assembled by the port at a perturbed state, and random
stores at the full bench plan's shapes (71 offsets, NVp 6144), at a row
count that is not a multiple of the preconditioner's rows per CTA, and
at NVp 16384, whose f32 store overflows the card's shared memory (the
preconditioner then reads its last lanes from global memory); for the
adjoint's (NV, 3) operator and GMRES, the true Hessian of the small and of
the full bench scene at a perturbed state. The dense path of small scenes
(no hand kernel: cuSOLVER's batched eigh, the scatter-add assembly with
atomics, the LU solve) is held against its own CPU results in f64 on the
small folding scene, and one step of every other task scene at its
published size against the same step on the CPU. The policy-search
layers: one CMAESDriver generation on forming under solver="cg" (finite,
both kernels launched) and one PPO update in f64 against the same update
on the CPU. The preview's triangle fill (render/raster.py) against the
same fill on the CPU, pixel for pixel. The mesh (parallel/mesh.py):
sharded population rewards on a world of one over NCCL against the serial
rollouts, and a mesh of more cards than there are refused.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from thinshelllab_torch.engine import elements, solver, stepper
from thinshelllab_torch.ops import dia_spmv as K
from thinshelllab_torch.ops import spd
from thinshelllab_torch.scenes import bench_scene, folding

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


def _random_operator(device, dtype, offsets, NVp):
    g = torch.Generator().manual_seed(1)
    n_off = len(offsets)
    dia = torch.randn((n_off, 3, 3, NVp), generator=g, dtype=torch.float64)
    dinv = torch.randn((3, 3, NVp), generator=g, dtype=torch.float64) * 0.1
    unf2 = (torch.rand((3, NVp), generator=g) > 0.1).double()
    t = [a.to(device, dtype) for a in (dia, dia, dinv, unf2)]
    return (offsets, *t)


def _bench_offsets():
    return bench_scene.make(cloth_N=70, table_n=12).spec.dia.offsets


def _bench_shaped_operator(device, dtype):
    return _random_operator(device, dtype, _bench_offsets(), 6144)


def _ragged_operator(device, dtype):
    """NVp 6004: 125 CTAs of 48 rows and a last one of 4."""
    return _random_operator(device, dtype, _bench_offsets(), 6004)


def _spilling_operator(device, dtype):
    """71 lanes over NVp 16384: 128 rows a CTA, whose f32 slice (327 KB)
    overflows the shared memory of an SM."""
    return _random_operator(device, dtype, _bench_offsets(), 16384)


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
    assert K.LAUNCHES == {"dia_spmv": 1, "dia_precond": 1}
    y_ref = K.dia_spmv_plain(dia, x2, offs)
    z_ref = K.dia_precond_plain(dia_pre, x2, unf2, dinv, offs, w, sweeps)
    for got, ref in ((y, y_ref), (z, z_ref)):
        assert got.dtype == dtype and got.shape == ref.shape
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err <= RTOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("sweeps", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("make", [_small_operator, _bench_shaped_operator,
                                  _ragged_operator, _spilling_operator],
                         ids=["bench8", "bench70_shapes", "ragged6004",
                              "spill16384"])
def test_precond_kernel_matches_plain(cuda, dtype, make, sweeps):
    """One launch per call, for either parity of the ping-pong buffers, on
    stores that fit, do not fit, and do not split evenly into CTAs."""
    offs, _, dia_pre, dinv, unf2 = make(cuda, dtype)
    g = torch.Generator().manual_seed(4)
    r2 = torch.randn(unf2.shape, generator=g, dtype=torch.float64).to(
        cuda, dtype) * unf2
    plan = K.device_precond_plan(cuda.index, r2.shape[1], tuple(offs), dtype)
    K.reset_launches()
    z = K.dia_precond(dia_pre, r2, unf2, dinv, offs, 0.8, sweeps)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"dia_spmv": 0, "dia_precond": 1}
    z_ref = K.dia_precond_plain(dia_pre, r2, unf2, dinv, offs, 0.8, sweeps)
    assert z.dtype == dtype and z.shape == z_ref.shape
    err = float((z - z_ref).abs().max() / z_ref.abs().max())
    print(f"{make.__name__} {dtype} sweeps {sweeps}: {plan}, err {err:.3e}")
    assert err <= RTOL[dtype], (err, plan)
    if make is _spilling_operator and dtype == torch.float32:
        assert plan.staged < len(offs)


@pytest.mark.cuda
def test_precond_plan_on_the_card(cuda):
    """The f32 bench store is held whole: one CTA per SM of 48 rows."""
    offs = _bench_offsets()
    plan = K.device_precond_plan(cuda.index, 6144, tuple(offs),
                                 torch.float32)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan.grid <= sms and plan.staged == len(offs), plan
    if sms == 132:
        assert (plan.rows, plan.grid) == (48, 128), plan
    f64 = K.device_precond_plan(cuda.index, 6144, tuple(offs), torch.float64)
    assert 0 < f64.staged < len(offs), f64


@pytest.mark.cuda
def test_precond_launch_failures_raise(cuda):
    """A grid that cannot be co-resident, or a geometry that does not cover
    the rows, raises; nothing falls back."""
    offs, _, dia_pre, dinv, unf2 = _bench_shaped_operator(cuda, torch.float32)
    offs_t = torch.tensor(offs, dtype=torch.int32, device=cuda)
    plan = K.device_precond_plan(cuda.index, 6144, tuple(offs),
                                 torch.float32)
    # 1536 CTAs of 4 rows, each claiming the whole shared-memory budget
    wide = dataclasses.replace(plan, rows=4, grid=1536)
    short = dataclasses.replace(plan, grid=plan.grid - 1)
    K.reset_launches()
    for bad in (wide, short):
        with pytest.raises(RuntimeError):
            K._precond_launch(bad, dia_pre, unf2, unf2, dinv, offs_t, 0.8, 3)
    assert K.LAUNCHES["dia_precond"] == 0


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


def _adjoint_system(device, dtype, cloth_N, jitter=1e-4):
    """The adjoint's element groups (true Hessian) of the bench scene at a
    state perturbed by `jitter` metres, and a right-hand side on the
    unfrozen DOFs."""
    sc = bench_scene.make(cloth_N=cloth_N, table_n=4 if cloth_N < 70 else 12,
                          dtype=torch.float64, hess_refresh=8)
    spec, s0, params = sc.to(device, dtype)
    g = torch.Generator().manual_seed(3)
    pos = s0.pos + jitter * torch.randn(s0.pos.shape, generator=g,
                                        dtype=torch.float64).to(device, dtype)
    contact, _, _ = stepper.build_contacts(spec, params, pos, pos,
                                           s0.proj_flag, s0.proj_dir)
    groups = elements.all_groups(spec, params, pos, s0.ref_angle, contact,
                                 with_hess=True, spd=False)
    F = torch.randn(s0.pos.shape, generator=g, dtype=torch.float64).to(
        device, dtype) * spec.dev.unf.to(dtype)
    return spec, groups, F


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cloth_N", [8, 70], ids=["bench8", "bench70"])
def test_hvp_dia_kernel_matches_plain(cuda, dtype, cloth_N):
    """The adjoint's operator apply, with the dia_spmv kernel and without."""
    spec, groups, F = _adjoint_system(cuda, dtype, cloth_N)
    st = solver.prepare_solver_state(spec, groups, dtype)
    K.reset_launches()
    y = solver._ops_from_state(spec, st)(F)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"dia_spmv": 1, "dia_precond": 0}
    y_ref = solver._ops_from_state(spec.replace(spmv="plain"), st)(F)
    assert K.LAUNCHES["dia_spmv"] == 1
    assert y.dtype == dtype and y.shape == F.shape
    err = float((y - y_ref).abs().max() / y_ref.abs().max())
    assert err <= RTOL[dtype], err


# GMRES with the kernel vs plain. f64 runs to adj_tol 1e-10 (or to its
# floor test): the solutions agree to max |dz| / max |z| <= 1e-7 (measured
# 5e-15 on the small scene, 4e-9 on the full one). f32 stops at its
# residual floor, which for this random right-hand side on the full scene
# is a relative residual |F - A z| / |F| of about 5e-2 (measured on the
# card: 4.8e-2 with the kernel after 67 iterations, 4.9e-2 plain after
# 68, solutions 8% apart); so in f32 the two residuals are held to
# F32_RESIDUAL and to within F32_RATIO of each other instead. The state is
# jittered by 1e-6 m: 1e-4 m bends the full cloth's 1.4 mm cells into a
# strongly indefinite Hessian, where f32 GMRES can leave early through its
# stagnation exit.
GMRES_RTOL = 1e-7
F32_RESIDUAL, F32_RATIO = 1e-1, 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("cloth_N", [8, 70], ids=["bench8", "bench70"])
def test_solve_gmres_kernel_matches_plain(cuda, dtype, cloth_N):
    spec, groups, F = _adjoint_system(cuda, dtype, cloth_N, jitter=1e-6)
    if dtype == torch.float64:
        spec = spec.replace(adj_tol=1e-10)
    A = solver._ops_from_state(
        spec, solver.prepare_solver_state(spec, groups, dtype))
    K.reset_launches()
    z, it = solver.solve_adjoint(spec, groups, F, return_iters=True)
    torch.cuda.synchronize()
    # one operator apply per iteration and one per restart
    assert it > 0 and K.LAUNCHES["dia_spmv"] >= it + 1
    assert K.LAUNCHES["dia_precond"] == 0
    K.reset_launches()
    z_ref, it_ref = solver.solve_adjoint(spec.replace(spmv="plain"), groups,
                                         F, return_iters=True)
    assert K.LAUNCHES["dia_spmv"] == 0
    assert bool(torch.isfinite(z).all())
    err = float((z - z_ref).abs().max() / z_ref.abs().max())
    res, res_ref = (float(torch.linalg.vector_norm(F - A(v))
                          / torch.linalg.vector_norm(F)) for v in (z, z_ref))
    print(f"{cloth_N} {dtype}: iters {it} / {it_ref}, relative residual "
          f"{res:.3e} / {res_ref:.3e}, max |dz| / max |z| {err:.3e}")
    if dtype == torch.float64:
        assert err <= GMRES_RTOL, (err, it, it_ref)
    else:
        assert max(res, res_ref) <= F32_RESIDUAL, (res, res_ref, it, it_ref)
        assert max(res / res_ref, res_ref / res) <= F32_RATIO, (res, res_ref)


@pytest.mark.cuda
def test_dense_path_matches_cpu(cuda):
    """project_psd (eigh), dense_hessian, the scatter residual and
    solve_dense on the card against the CPU, f64, on one contact set: the
    small folding scene at a perturbed state, and seeded 9x9 / 12x12
    blocks with repeated eigenvalues."""
    sc = folding.make(table_n=4, max_newton_iter=30)
    g = torch.Generator().manual_seed(0)
    pert = 1e-4 * torch.randn(sc.state0.pos.shape, generator=g,
                              dtype=torch.float64)
    blocks = []
    for k in (9, 12):
        A = torch.randn((64, k, k), generator=g, dtype=torch.float64)
        lam = torch.randn((64, k), generator=g, dtype=torch.float64)
        lam[:, 0:2], lam[:, 2:5] = -1.5, 2.0
        Q, _ = torch.linalg.qr(A)
        blocks.append(torch.cat([A + A.transpose(1, 2),
                                 Q @ torch.diag_embed(lam) @ Q.transpose(1, 2)]))
    out, contact = {}, None
    for dev in (torch.device("cpu"), cuda):
        spec, s0, params = sc.to(dev, torch.float64)
        pos = s0.pos + pert.to(dev) * spec.dev.unf
        if contact is None:
            contact, _, _ = stepper.build_contacts(
                spec, params, pos, s0.pos, s0.proj_flag, s0.proj_dir)
        con = contact.to(dev, torch.float64)
        groups = elements.all_groups(spec, params, pos, s0.ref_angle, con,
                                     with_hess=True, spd=True)
        F = elements.assemble_residual(spec, groups, pos, s0.pos, s0.vel)
        out[dev.type] = dict(
            psd9=spd.project_psd(blocks[0].to(dev)),
            psd12=spd.project_psd(blocks[1].to(dev)),
            H_el=groups["H"], H=elements.dense_hessian(spec, groups), F=F,
            p=solver.solve_dense(spec, groups, F))
    assert int(contact.active.sum()) > 0
    for key, want in out["cpu"].items():
        got = out["cuda"][key].cpu()
        err = float((got - want).abs().max() / want.abs().max())
        print(f"{key}: max rel err {err:.3e}")
        assert err <= 1e-10, (key, err)


# the task scenes whose contact sets the CPU and the card may decide
# differently at tied slots (ROADMAP.md §3); the step below shares the
# CPU's set, and their own sets are not compared
TIE_SCENES = ("sliding", "card", "pick", "interact")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lifting", "sliding", "card", "pick",
                                  "forming", "balancing", "bouncing",
                                  "interact"])
def test_scene_step_matches_cpu(cuda, name):
    """Each task scene built on the card at its published size: one f64
    step (the pads 0.2 mm down, Newton capped at 5) against the same step
    on the CPU, both minimising with the CPU's contact set; the card's own
    contact set has the CPU's active flags where no slot ties."""
    from thinshelllab_torch.engine import gripper
    from thinshelllab_torch.scenes import registry

    sc = registry.make_scene(name, solver="auto", max_newton_iter=5)
    n = sc.n_part
    act = (torch.zeros((n, 3), dtype=torch.float64),
           torch.zeros((n, 3), dtype=torch.float64),
           torch.zeros((n,), dtype=torch.float64))
    act[0][:, 2] = -2e-4
    out, contact = {}, None
    for dev in (torch.device("cpu"), cuda):
        spec, s0, params = sc.to(dev, torch.float64)
        gs = gripper.gripper_step(spec, s0.gripper,
                                  *(a.to(dev) for a in act))
        pos = gripper.write_bound_vertices(spec, s0.pos, gs)
        own, _, _ = stepper.build_contacts(spec, params, pos, pos,
                                           s0.proj_flag, s0.proj_dir)
        if contact is None:
            contact = own
        elif name not in TIE_SCENES:
            assert torch.equal(own.active.cpu(), contact.active)
        out[dev.type] = solver.newton_solve(
            spec, params, pos, pos, s0.vel, s0.ref_angle,
            contact.to(dev, torch.float64))
    assert int(contact.active.sum()) > 0
    err = float((out["cuda"].cpu() - out["cpu"]).abs().max())
    print(f"{name}: max |dpos| card vs CPU {err:.3e} m")
    assert err <= 1e-9, err


# the DIA plans the task scenes build under solver="cg" (21 to 351 offsets
# over 1024 or 2048 rows) and the 40k-triangle bench's (71 over 20,480):
# (n_off, NVp) of each, by the scene that builds it
CG_PLANS = {"bouncing": (21, 1024), "forming": (63, 1024),
            "sliding": (69, 2048), "pick": (213, 2048),
            "lifting": (285, 2048), "balancing": (351, 2048),
            "bench140": (71, 20480)}


def _cg_plan_offsets(name):
    """The scene's own offsets: their largest reach 32 to 282 rows."""
    from thinshelllab_torch.scenes import registry

    if name == "bench140":
        sc = bench_scene.make(cloth_N=140, table_n=12, dtype=torch.float32)
    else:
        sc = registry.make_scene(name, solver="cg")
    return sc.spec.dia.offsets, sc.spec.dia.NVp


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(CG_PLANS))
def test_kernels_on_cg_scene_plans(cuda, dtype, name):
    """Both kernels against their plain versions on random stores of each
    cg plan's shape and offsets (the preconditioner's window spans
    rows + 2 max|offset|; 351 f64 lanes leave most of the store in global
    memory; 20,480 rows spread over every SM)."""
    offs, NVp = _cg_plan_offsets(name)
    assert (len(offs), NVp) == CG_PLANS[name]
    offs, dia, dia_pre, dinv, unf2 = _random_operator(cuda, dtype, offs, NVp)
    g = torch.Generator().manual_seed(5)
    x2 = torch.randn(unf2.shape, generator=g, dtype=torch.float64).to(
        cuda, dtype) * unf2
    plan = K.device_precond_plan(cuda.index, NVp, tuple(offs), dtype)
    K.reset_launches()
    y = K.dia_spmv(dia, x2, offs)
    z = K.dia_precond(dia_pre, x2, unf2, dinv, offs, 0.8, 3)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"dia_spmv": 1, "dia_precond": 1}
    for got, ref in ((y, K.dia_spmv_plain(dia, x2, offs)),
                     (z, K.dia_precond_plain(dia_pre, x2, unf2, dinv, offs,
                                             0.8, 3))):
        err = float((got - ref).abs().max() / ref.abs().max())
        print(f"{name} {dtype}: {plan}, err {err:.3e}")
        assert err <= RTOL[dtype], (err, plan)


@pytest.mark.cuda
def test_pull_path_matches_cpu(cuda):
    """folding under solver="cg" (no DIA plan): hvp_pull, the block
    diagonal, pull CG and MINRES on the card against the CPU, f64, on the
    CPU's element blocks at the established-contact state of
    tests/test_assembly.py's MINRES test (table_n=5, the pad pressed 0.6
    mm a step for 3 dense steps), where MINRES converges below its cap."""
    spec, s0, params = folding.make(table_n=5, max_newton_iter=20).to("cpu")
    sc = folding.make(table_n=5, max_newton_iter=20, solver="cg")
    dpos = torch.zeros((3, sc.n_part, 3), dtype=torch.float64)
    dpos[:, :, 2] = -6e-4
    st, _ = stepper.rollout(spec, params, s0, (
        dpos, torch.zeros_like(dpos),
        torch.zeros((3, sc.n_part), dtype=torch.float64)))
    contact, _, _ = stepper.build_contacts(spec, params, st.pos, st.pos,
                                           st.proj_flag, st.proj_dir)
    groups = {s: elements.all_groups(spec, params, st.pos, st.ref_angle,
                                     contact, with_hess=True, spd=s)
              for s in (True, False)}
    g = torch.Generator().manual_seed(3)
    F = torch.randn(st.pos.shape, generator=g, dtype=torch.float64)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        spec_d, _, _ = sc.to(dev, torch.float64)
        assert spec_d.dia is None and spec_d.hvp_slots is not None
        gr = {s: {k: v.to(dev) for k, v in grp.items()}
              for s, grp in groups.items()}
        Fd = F.to(dev) * spec_d.dev.unf
        nbr = elements.gather_neighbor_blocks(spec_d, gr[True],
                                              torch.float64)
        z, it = solver.solve_adjoint(spec_d, gr[False], Fd,
                                     return_iters=True)
        assert 0 < it < spec_d.cg_max_iter
        out[dev.type] = dict(
            hvp=elements.hvp_pull(spec_d, nbr, gr[True], Fd),
            D=elements.diag_blocks(spec_d, gr[True]),
            cg=solver.solve_cg(spec_d, gr[True], Fd), minres=z)
    for key, want in out["cpu"].items():
        err = float((out["cuda"][key].cpu() - want).abs().max()
                    / want.abs().max())
        print(f"{key}: max rel err {err:.3e}")
        assert err <= 1e-9, (key, err)


@pytest.mark.cuda
def test_hash_broadphase_matches_cpu(cuda):
    """The spatial-hash projection on the card against the CPU, f64, on
    bench cloth_N=32 forced onto the hash (hash_min_faces=0), at the
    settled state of tests/test_collision.py, by that test's criterion:
    flags and directions equal, projection distances within 1.01e-5 m (a
    tie inside the near-window may pick another face), faces equal on all
    but max(5, 2%) of the found rows; and the weights of the rows on one
    face within 1e-12."""
    from thinshelllab_torch.ops import collision

    sc = bench_scene.make(cloth_N=32, dtype=torch.float64, solver="cg")
    out = {}
    for dev in (torch.device("cpu"), cuda):
        spec, s0, _ = sc.to(dev, torch.float64)
        spec = spec.replace(contact=spec.contact.replace(hash_min_faces=0))
        p = s0.pos.clone()
        p[:, 2] -= 0.4 * (p[:, 2] - p[:, 2].min())
        vn = collision.vertex_normals(p, spec.faces, spec.NV)
        z = torch.zeros_like(s0.proj_flag)
        out[dev.type] = [t.cpu() for t in collision.projection_query(
            spec, p, vn, z, z)] + [p.cpu()]
    (f1, d1, t1, w1, p), (f2, d2, t2, w2, _) = out["cuda"], out["cpu"]
    assert torch.equal(f1, f2) and torch.equal(d1, d2) and int(f1.sum()) > 0
    m = f1.bool()
    same = (t1 == t2).all(dim=1) & m
    print(f"faces differ on {int(m.sum() - same.sum())} of {int(m.sum())}")
    assert int(m.sum() - same.sum()) <= max(5, 0.02 * int(m.sum()))
    assert float((w1[same] - w2[same]).abs().max()) <= 1e-12
    q = p[spec.contact.cq_vert.cpu()]

    def dist(t, w):
        return torch.linalg.vector_norm(
            q - torch.einsum("ck,cki->ci", w, p[t]), dim=1)[m]

    assert float((dist(t1, w1) - dist(t2, w2)).abs().max()) <= 1.01e-5


@pytest.mark.cuda
def test_cmaes_generation_on_forming_under_cg(cuda):
    """One CMAESDriver generation (pop 2, T=2) on forming at its published
    size under solver="cg" in f32, Newton capped at 5: finite rewards, and
    the rollouts went through both kernels."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.cmaes import CMAESDriver

    sc = registry.make_scene("forming", solver="cg", dtype=torch.float32,
                             max_newton_iter=5)
    drv = CMAESDriver(sc, 2, 2, pop_size=2, seed=0, device=cuda)
    K.reset_launches()
    info = drv.generation()
    launches = dict(K.LAUNCHES)
    print(f"rewards {info['rewards']}, launches {launches}")
    assert np.all(np.isfinite(info["rewards"]))
    assert min(launches.values()) > 0, launches


@pytest.mark.cuda
def test_ppo_update_matches_cpu(cuda):
    """One PPOTrainer update in f64 on the card against the same update on
    the CPU (the same seeded weights and batch), every parameter within
    1e-10."""
    from thinshelllab_torch.train.ppo import PPOTrainer

    class Stub:
        n, scene = 3, types.SimpleNamespace(n_part=1)

        def reset(self):
            return np.zeros((3, 40), np.float32)

    rng = np.random.default_rng(0)
    B = 32
    batch = (rng.normal(size=(B, 40)).astype(np.float32),
             rng.normal(size=(B, 6)), rng.normal(size=B),
             rng.normal(size=B), rng.normal(size=B) - 5.0)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        tr = PPOTrainer(Stub(), hidden=64, seed=1, device=dev,
                        dtype=torch.float64)
        tr.update(batch)
        tr.update(batch)
        out[dev.type] = [p.detach().cpu() for p in tr.optimizer.param_groups[
            0]["params"]]
    err = max(float((a - b).abs().max())
              for a, b in zip(out["cuda"], out["cpu"]))
    print(f"max |d param| card vs CPU {err:.3e}")
    assert err <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ppo", "sac", "recurrent_ppo"])
def test_trainers_train_on_the_card(cuda, algo):
    """Each native trainer's training loop on the card (a stub env whose
    observations come back as numpy, as BatchedEnv's do): finite
    parameters and actions after a few updates."""
    from thinshelllab_torch.train.ppo import PPOTrainer
    from thinshelllab_torch.train.recurrent_ppo import RecurrentPPOTrainer
    from thinshelllab_torch.train.sac import SACTrainer

    class Stub:
        n, scene = 4, types.SimpleNamespace(n_part=1)

        def reset(self):
            return np.zeros((4, 7), np.float32)

        def step(self, act):
            return (np.ones((4, 7), np.float32),
                    np.asarray(act)[:, 0] * 1e3, np.array([0, 1, 0, 1],
                                                         bool))

    kw = {"sac": dict(start_steps=8, batch_size=8),
          "ppo": dict(horizon=4), "recurrent_ppo": dict(horizon=4)}[algo]
    make = {"ppo": PPOTrainer, "sac": SACTrainer,
            "recurrent_ppo": RecurrentPPOTrainer}[algo]
    tr = make(Stub(), total_steps=32, hidden=16, device=cuda, **kw)
    tr.train(verbose=False)
    params = [p for v in vars(tr).values()
              if isinstance(v, torch.optim.Optimizer)
              for g in v.param_groups for p in g["params"]]
    assert params and all(p.device.type == "cuda" for p in params)
    assert all(bool(torch.isfinite(p).all()) for p in params)
    a = tr.act(Stub().reset())
    a = a[0] if isinstance(a, tuple) else a
    assert a.shape == (4, 6) and np.all(np.isfinite(a))


@pytest.mark.cuda
def test_raster_fill_matches_cpu(cuda):
    """The preview's triangle fill (render/raster.py) on the card equals
    the same fill on the CPU pixel for pixel: the folding scene's faces
    projected in painter's order at two states, and random triangles."""
    from thinshelllab_torch.render import preview, raster

    sc = folding.make()
    faces = np.asarray(sc.spec.faces)
    rng = np.random.default_rng(0)
    for k in range(2):
        pos = np.asarray(sc.state0.pos) + 1e-3 * k * rng.standard_normal(
            np.shape(sc.state0.pos))
        view = raster.Axes3DView(((-0.08, 0.08), (-0.08, 0.08),
                                  (-0.03, 0.06)))
        order = preview.painter_order(pos, faces, (-0.2, 0.2, 0.05), view.M)
        tri = view.to_pixels(torch.as_tensor(pos))[
            torch.as_tensor(faces[order], dtype=torch.int64)]
        want = raster.fill_triangles(tri, 600, 600, box=view.box)
        got = raster.fill_triangles(tri.to(cuda), 600, 600, box=view.box)
        assert (want >= 0).any()
        assert torch.equal(got.cpu(), want)
    tri = torch.as_tensor(rng.uniform(-20, 220, (3000, 1, 2))
                          + rng.uniform(-15, 15, (3000, 3, 2)))
    assert torch.equal(
        raster.fill_triangles(tri.to(cuda), 200, 200, chunk=1 << 16).cpu(),
        raster.fill_triangles(tri, 200, 200, chunk=1 << 16))


@pytest.mark.cuda
def test_sharded_population_rewards_on_an_nccl_world_of_one(cuda):
    """sharded_population_rewards on a world of one over NCCL equals the
    serial batched_rollout_rewards on the card: the small bench under cg
    in f64, two members pressing 2 mm a step (the cloth jittered by 1e-6
    m, as the CPU tests do, so that no contact query sits at an exact
    tie), and the rollouts went through both kernels. The two runs sum
    their scatter-adds with atomics in another order, and CG stops at its
    tolerance: 1e-9 relative."""
    from thinshelllab_torch.parallel import mesh as pmesh

    sc = bench_scene.make(cloth_N=8, table_n=4, dtype=torch.float64,
                          solver="cg", max_newton_iter=2, cg_max_iter=40,
                          cg_tol=1e-8)
    spec, s0, params = sc.to(cuda)
    n_cloth = 9 ** 2
    pos0 = s0.pos.cpu().numpy().copy()
    pos0[:n_cloth] += 1e-6 * np.random.default_rng(0).normal(size=(n_cloth,
                                                                   3))
    s0 = s0.replace(pos=torch.as_tensor(pos0, device=cuda))
    rng = np.random.default_rng(3)
    dpos = rng.normal(size=(2, 2, 1, 3)) * 1e-4
    dpos[..., 2] -= 2e-3
    acts = tuple(torch.as_tensor(a, device=cuda) for a in (
        dpos, np.zeros((2, 2, 1, 3)), np.zeros((2, 2, 1))))
    reward = sc.rewards["default"]
    mesh = pmesh.make_mesh(1)
    try:
        assert (mesh.size, mesh.rank, mesh.device) == (1, 0, cuda)
        K.reset_launches()
        got = pmesh.sharded_population_rewards(mesh, spec, params, s0, acts,
                                               reward)
        launches = dict(K.LAUNCHES)
    finally:
        mesh.close()
    want = pmesh.batched_rollout_rewards(spec, params, s0, acts, reward)
    print(f"rewards {got.tolist()} vs {want.tolist()}, launches {launches}")
    assert got.shape == (2,) and got.device == cuda
    assert min(launches.values()) > 0, launches
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-9, atol=0)


@pytest.mark.cuda
def test_mesh_refuses_more_cards_than_there_are(cuda):
    """make_mesh and dryrun_multichip raise, before any rank starts, when
    asked for more cards than the machine has; nothing moves to gloo or
    the CPU."""
    from thinshelllab_torch import entry
    from thinshelllab_torch.parallel import mesh as pmesh

    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="cards asked for"):
        pmesh.make_mesh(n)
    with pytest.raises(RuntimeError, match="cards asked for"):
        entry.dryrun_multichip(n)
