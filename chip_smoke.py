"""Smoke run of thinshelllab_torch on one CUDA card.

Builds the two DIA kernels (csrc/dia_spmv.cu) with nvcc, holds each against
its plain PyTorch version (and times a PyTorch sparse product beside
dia_spmv) on the full bench scene's assembled operator, with the L2 warm
from the call before and cold (a 64 MiB buffer written between calls),
holds the preconditioner against its plain version on a store that
overflows the card's shared memory as well, holds a small f64
rollout and a small f64 forward+backward against the JAX package's saved
positions and gradients (tests/data/bench8_golden.npz,
tests/data/bench8_adjoint_golden.npz), then runs the bench scene's main
path at full size (cloth_N=70: 5,605 vertices, 9,800 cloth triangles) in
f32 with the kernels: the forward rollout, `seed_loss` and the adjoint
backward. Both halves run once more on the plain path, the backward once
more in f64 on the same tape, and the forward+backward once under phase
timers and once under the profiler. On the bench's actions the pad never
touches the cloth (the cloth sinks faster than the pad's 0.4 mm a step),
so the bench's gripper gradient is zero; a later phase runs the full-size
forward+backward with the pad pressing 2 mm a step, where it is not.
A short bench forward then takes the full-Newton branch (hess_refresh=1)
through both kernels.

The folding task's trajectory optimisation follows, on the dense solve
(no hand kernel: cuSOLVER's batched eigh, the LU solve): the small f64
folding trajopt against the JAX package's saved run
(tests/data/folding_trajopt_golden.npz), then the published scene in f32
through `registry.make_scene("folding", solver="auto")` and
`TrajOptDriver` at T=FOLD_T for FOLD_ITERS iteration (the CLI runs more),
the f32 gradient held against an f64 backward on the same tape, and phase
timers and a profiler pass over a shorter rollout.

Every other task scene of the registry follows (lifting, sliding, card,
pick, forming, balancing, bouncing, interact), each at its published
size: [scenes-golden] holds the CPU tests' small f64 runs against the
JAX package's saved runs (tests/data/scenes_golden.npz; the scenes whose
contact ties the two packages decide differently are held on the JAX
tape instead: each step replayed from the JAX state with the JAX contact
set, and the backward); [scenes] runs a 3-step f64 forward and
backward at the published Newton cap; [scenes-trajopt] one f32
TrajOptDriver iteration of every scene with a gripper; [dp] the system
identification drivers on bouncing and card.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line of per-kernel results, the
card's `nvidia-smi` name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure raises, exits non-zero and
prints no result line. Needs CUDA; there is no CPU path.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "bench8_golden.npz")
GOLDEN_ADJ = os.path.join(ROOT, "tests", "data", "bench8_adjoint_golden.npz")
GOLDEN_FOLD = os.path.join(ROOT, "tests", "data",
                           "folding_trajopt_golden.npz")

# kernel vs plain version, max |kernel - plain| / max |plain|: both sum the
# same 9 * n_off products per row in another order; the preconditioner
# adds three D^-1 sweeps on top. f32 keeps ~7 digits, f64 ~16.
KERNEL_RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# small f64 rollout vs the JAX positions (metres, scene size 0.1 m, 8e-4 m
# of motion): both run CG to fwd_tol 1e-10, so the fused preconditioner's
# variant and the summation order move positions far below this
GOLDEN_ATOL = 1e-8
# full-size f32 rollout, plain path vs kernels, max |dpos| / max cloth
# displacement. The two use different preconditioners (the fused kernel
# drops the leftover rows' off-diagonal couplings), so their inexact
# (fwd_tol 1e-3) CG directions differ; and at the bench settings Newton
# stops at max_newton_iter = 8 in every step, short of newton_tol, so each
# step keeps an unconverged remainder that follows those directions. The
# positions therefore agree to a few percent of the motion, not to
# rounding; a wrong operator or preconditioner moves them by the whole
# displacement.
PLAIN_VS_KERNEL_RTOL = 1e-1
# small f64 forward+backward vs the JAX gradients, max |d| / max |JAX|:
# forward CG to 1e-10, GMRES to adj_tol 1e-10 on both sides, sums in
# another order (the CPU port agrees to 1e-12)
GOLDEN_ADJ_RTOL = 1e-7
# full-size f32 backward, plain path vs kernels on one tape, max |d| / max
# |plain| of gripper_grad and pos_grad0: f32 GMRES stops at its residual
# floor, so operators that differ by rounding end at different points
# near it
ADJ_PLAIN_RTOL = 5e-2
T_STEPS = 8
# the profiler pass's rollout: reading back the trace of T_STEPS took a
# minute of the script's time budget
T_PROFILE = 2
DISPLACEMENT_Z = -4e-4  # bench.py:143-149: the pad moves 0.4 mm down a step
# the pressing run: the pad moves 2 mm down a step and reaches the cloth
T_PRESS, PRESS_Z = 4, -2e-3
# the small f64 folding trajopt vs the JAX run: Newton to newton_tol 1e-7
# and dense LU solves on both sides, sums in another order (the CPU port
# agrees to 1e-13 and below)
FOLD_POS_ATOL, FOLD_REF_ATOL = 1e-8, 1e-9  # metres, radians
FOLD_REWARD_RTOL, FOLD_GRAD_RTOL = 1e-9, 1e-6
# an Adam step of lr 1e-3 moves a waypoint by at most ~1e-3 per unit of
# m_hat / sqrt(v_hat); a 1e-6 relative error of g moves it by ~1e-9 m
FOLD_TRAJ_ATOL = 1e-8
# the f32 folding gradient vs an f64 backward on the same f32 tape,
# |g32 - g64| / |g64| in the L2 norm: the definition of the JAX package's
# CPU-f32 dense figure of 4.3e-3 (BASELINE.md:211, scripts/grad_accuracy.py)
FOLD_F32_RTOL = 1e-2
# the published folding trajopt, cut in depth from the reference's 50
# waypoints (run_trajopt_folding.sh) to make room for the task scenes
# within the script's time target; its T=50 times are in PERF.md
FOLD_T, FOLD_ITERS = 10, 1
# the shorter rollout of the folding phase timers and f32 spread, and the
# Newton cap of the profiler pass over its first step
FOLD_PHASE_STEPS, FOLD_PROFILE_NEWTON = 1, 3
# the task scenes beside folding and bench, at their published sizes
NEW_SCENES = ("lifting", "sliding", "card", "pick", "forming", "balancing",
              "bouncing", "interact")
GOLDEN_SCENES = os.path.join(ROOT, "tests", "data", "scenes_golden.npz")
# [scenes-golden]: the CPU test's f64 run (T=2, max_newton_iter=5, the
# JAX smoke test's actions) against the JAX package's saved run, with the
# CPU test's tolerances: dense LU on both sides, sums in another order
SCENE_GOLDEN_T, SCENE_GOLDEN_NEWTON = 2, 5
SCENE_POS_ATOL, SCENE_GRAD_RTOL = 1e-9, 1e-7
# the scenes whose CPU rollout test is a strict xfail
# (tests/test_torch_scene_rollouts.py TIES, ROADMAP.md §3): the packages
# decide tied contact slots differently, so the rollout is printed, not
# gated, and the backward is gated on the JAX package's own tape
SCENE_TIES = {
    "sliding": "36 contact slots decided differently at the initial state",
    "card": "20-21 contact slots decided differently after step 1",
    "pick": "2 active slots take the other of two tied coplanar pad faces",
    "interact": "20 contact slots decided differently at the initial state",
}
# [scenes]: each scene in f64 at its published Newton cap, T steps of the
# JAX smoke test's actions (each pad 0.2 mm down a step; T cut from 4 to 3
# for the script's time target, PERF.md); its bound on the displacement
# (tests/test_scenes.py:36)
SCENES_T, SCENE_DZ, SCENE_DISP_MAX = 3, -2e-4, 0.05
# [scenes-trajopt]: one f32 TrajOptDriver iteration (the CLI's card
# default) at this T for every scene with a gripper
SCENES_TRAJOPT_T = 3
# [dp]: ParamOptDriver iterations on bouncing and one ParamCMAESDriver
# generation on card, f32 as the CLI runs them on a card (T cut from 3 to
# 2, one step, for the script's time target, PERF.md)
DP_T, DP_ITERS, DP_LR, DP_POP = 2, 2, 1.0, 4
# the card's published peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s
# and float32 FLOP/s outside the tensor cores, at a 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# written between calls for a cold-L2 time: larger than the 50 MB L2
FLUSH_BYTES = 64 * 2**20
# a store whose f32 slice per CTA overflows shared memory: the bench's 71
# offsets over 16384 rows (128 rows a CTA, 46 of 71 lanes held on an H100)
SPILL_NVP = 16384


def log(msg):
    print(msg, flush=True)


def timed(name, fn, *args):
    """fn(*args), and a line with its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def bench_actions(T, dtype, device, dz=None):
    dpos = torch.zeros((T, 1, 3), dtype=dtype, device=device)
    dpos[:, 0, 2] = DISPLACEMENT_Z if dz is None else dz
    return (dpos, torch.zeros((T, 1, 3), dtype=dtype, device=device),
            torch.zeros((T, 1), dtype=dtype, device=device))


def call_ms(fn, n=60, warmup=5):
    """Time per call (ms) of n back-to-back calls between two CUDA events:
    what a caller pays, the host's launch cost included where it exceeds
    the device's work."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n=60, key=None, cold=False, tries=3):
    """Device time per call (ms): the summed time of every CUDA kernel the
    n calls ran (of those whose name holds `key`, if given), from the
    profiler's trace of the card. cold: FLUSH_BYTES are written between
    calls, so that each call finds its inputs outside L2. A trace that holds
    none of the kernels is taken again, up to `tries` traces in all."""
    from torch.profiler import ProfilerActivity, profile

    flush = (torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                         device="cuda") if cold else None)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                if cold:
                    flush.fill_(1.0)
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(getattr(e, "self_device_time_total", None)
                 or getattr(e, "self_cuda_time_total", 0)
                 for e in events if key is None or key in e.key)
        if us > 0:
            return us / 1e3 / n
        log(f"[profile] no device time of {key or 'any kernel'} in a trace "
            f"of {[e.key[:50] for e in events]}")
    raise RuntimeError("the profiler recorded no device time")


def operator_inputs(sc, device, dtype):
    """The full bench scene's assembled DIA store and preconditioner inputs
    at its initial state, as the first Newton iteration builds them."""
    from thinshelllab_torch.engine import elements, solver, stepper

    spec, s0, params = sc.to(device, dtype)
    contact, _, _ = stepper.build_contacts(spec, params, s0.pos, s0.pos,
                                           s0.proj_flag, s0.proj_dir)
    groups = elements.all_groups(spec, params, s0.pos, s0.ref_angle, contact,
                                 with_hess=True, spd=True)
    st = solver.prepare_solver_state(spec, groups, dtype)
    D, Dinv = st["D"], solver._inv3x3(st["D"])
    NV, NVp = spec.NV, spec.dia.NVp
    dia_pre = st["dia"].clone()
    dia_pre[spec.dev.off0, :, :, :NV] = D.permute(1, 2, 0)
    dinv = torch.zeros((3, 3, NVp), dtype=dtype, device=device)
    dinv[:, :, :NV] = Dinv.permute(1, 2, 0)
    return spec, st["dia"], dia_pre, dinv


def bound_ms(n_bytes, n_flop):
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the float32 operations over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / F32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sparse_matvec(dia, offsets, layout):
    """The DIA store as one PyTorch sparse matrix over the vertex-major
    vector (3 NVp,): 'bsr' with the (3, 3) blocks, 'csr' with scalars.
    Block (n, n + o) is dia[o_index, :, :, n]; out-of-range columns drop."""
    n_off, _, _, NVp = dia.shape
    n = torch.arange(NVp, device=dia.device)
    rows, cols, vals = [], [], []
    for oi, o in enumerate(offsets):
        c = n + o
        ok = (c >= 0) & (c < NVp)
        rows.append(n[ok])
        cols.append(c[ok])
        vals.append(dia[oi][:, :, ok].permute(2, 0, 1))
    rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    size = (3 * NVp, 3 * NVp)
    if layout == "bsr":
        order = torch.argsort(rows * NVp + cols)
        crow = torch.zeros(NVp + 1, dtype=torch.int64, device=dia.device)
        crow[1:] = torch.cumsum(torch.bincount(rows, minlength=NVp), 0)
        return torch.sparse_bsr_tensor(crow, cols[order], vals[order],
                                       size=size)
    ij = torch.arange(3, device=dia.device)
    r = (3 * rows[:, None, None] + ij[None, :, None]).expand_as(vals)
    c = (3 * cols[:, None, None] + ij[None, None, :]).expand_as(vals)
    coo = torch.sparse_coo_tensor(torch.stack([r.reshape(-1), c.reshape(-1)]),
                                  vals.reshape(-1), size=size)
    return coo.coalesce().to_sparse_csr()


def library_spmv(dia, x2, offsets):
    """One PyTorch sparse matrix-vector call computing dia_spmv (BSR with
    3x3 blocks, else CSR): (call, layout, error text of a layout that did
    not run). The port never calls it."""
    xv = x2.T.contiguous().reshape(-1, 1)
    errors = []
    for layout in ("bsr", "csr"):
        try:
            S = sparse_matvec(dia, offsets, layout)
            S @ xv
            return (lambda: S @ xv), layout, "; ".join(errors)
        except (RuntimeError, NotImplementedError) as e:
            errors.append(f"{layout}: {str(e).splitlines()[0]}")
    return None, None, "; ".join(errors)


def precond_geometry(K, device, NVp, offsets, dtype):
    """The preconditioner's launch geometry as the wrapper sizes it, and a
    line of text that names it."""
    plan = K.device_precond_plan(device.index, NVp, tuple(offsets), dtype)
    text = (f"rows per CTA {plan.rows}, grid {plan.grid} CTAs of "
            f"{plan.threads} threads, {plan.staged} of {len(offsets)} lanes "
            f"staged, {plan.smem_bytes} B of shared memory per CTA")
    return plan, text


def spill_check(device):
    """The preconditioner on a random f32 store of the bench's offsets over
    SPILL_NVP rows, whose slice per CTA does not fit shared memory."""
    from thinshelllab_torch.ops import dia_spmv as K
    from thinshelllab_torch.scenes import bench_scene

    offs = bench_scene.make(cloth_N=70, table_n=12).spec.dia.offsets
    rng = np.random.default_rng(1)
    n_off, dtype = len(offs), torch.float32

    def t(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale, dtype=dtype,
                               device=device)

    dia, dinv = t(n_off, 3, 3, SPILL_NVP), t(3, 3, SPILL_NVP, scale=0.1)
    unf2 = torch.as_tensor(rng.random((3, SPILL_NVP)) > 0.1, dtype=dtype,
                           device=device)
    r2 = t(3, SPILL_NVP) * unf2
    plan, geo = precond_geometry(K, device, SPILL_NVP, offs, dtype)
    if plan.staged >= n_off:
        raise AssertionError(f"the spill store fits shared memory: {geo}")
    K.reset_launches()
    z = K.dia_precond(dia, r2, unf2, dinv, offs, 0.8, 3)
    torch.cuda.synchronize()
    launches = K.LAUNCHES["dia_precond"]
    zp = K.dia_precond_plain(dia, r2, unf2, dinv, offs, 0.8, 3)
    rel = float((z - zp).abs().max() / zp.abs().max())
    ms = device_ms(lambda: K.dia_precond(dia, r2, unf2, dinv, offs, 0.8, 3))
    log(f"[kernel] dia_precond float32 spill store {tuple(dia.shape)}: {geo};"
        f" {launches} launch per call; max rel err {rel:.3e} (tol "
        f"{KERNEL_RTOL[dtype]:.0e}); device time per call {ms:.4f} ms")
    if launches != 1 or not rel <= KERNEL_RTOL[dtype]:
        raise AssertionError(f"dia_precond on the spill store: {launches} "
                             f"launches, error {rel:.3e}")


def kernel_checks(sc, device):
    from thinshelllab_torch.ops import dia_spmv as K

    rng = np.random.default_rng(0)
    out = {}
    keys = {"dia_spmv": "dia_spmv_kernel",
            "dia_precond": "dia_precond_kernel"}
    for dtype in (torch.float32, torch.float64):
        spec, dia, dia_pre, dinv = operator_inputs(sc, device, dtype)
        unf2 = spec.dev.unf2
        NVp, offs, offs_t = spec.dia.NVp, spec.dia.offsets, spec.dev.offsets_t
        x2 = torch.as_tensor(rng.normal(size=(3, NVp)), dtype=dtype,
                             device=device) * unf2
        r2 = torch.as_tensor(rng.normal(size=(3, NVp)), dtype=dtype,
                             device=device) * unf2
        w, sweeps = spec.precond_omega, spec.precond_smooth
        cases = {
            "dia_spmv": (lambda: K.dia_spmv(dia, x2, offs, offs_t),
                         lambda: K.dia_spmv_plain(dia, x2, offs)),
            "dia_precond": (
                lambda: K.dia_precond(dia_pre, r2, unf2, dinv, offs, w,
                                      sweeps, offs_t),
                lambda: K.dia_precond_plain(dia_pre, r2, unf2, dinv, offs, w,
                                            sweeps)),
        }
        for name, (kern, plain) in cases.items():
            K.reset_launches()
            yk = kern()
            torch.cuda.synchronize()
            per_call = K.LAUNCHES[name]
            yp = plain()
            abs_err = float((yk - yp).abs().max())
            rel = abs_err / float(yp.abs().max())
            tol = KERNEL_RTOL[dtype]
            ms, plain_ms = device_ms(kern), device_ms(plain)
            cold_ms = device_ms(kern, 30, key=keys[name], cold=True)
            call, plain_call = call_ms(kern), call_ms(plain)
            geo = ""
            if name == "dia_precond":
                plan, geo = precond_geometry(K, device, NVp, offs, dtype)
                geo = f"{geo}; "
            log(f"[kernel] {name} {str(dtype)[6:]} shape {tuple(dia.shape)}: "
                f"{geo}{per_call} launch per call; max rel err {rel:.3e} "
                f"(tol {tol:.0e}), max abs err {abs_err:.3e}; device time "
                f"per call: kernel {ms:.4f} ms with a warm L2, {cold_ms:.4f} "
                f"ms with a cold L2, plain {plain_ms:.4f} ms; per call "
                f"between CUDA events: kernel {call:.4f} ms, plain "
                f"{plain_call:.4f} ms (60 calls)")
            if not rel <= tol:
                raise AssertionError(f"{name} {dtype}: kernel disagrees with "
                                     f"its plain version ({rel:.3e} > {tol})")
            if per_call != 1:
                raise AssertionError(f"{name}: {per_call} launches per call")
            it = dia.element_size()
            if name == "dia_spmv":
                # store, x in, y out; 2 operations per store entry
                n_bytes = (dia.numel() + 2 * x2.numel()) * it + 4 * len(offs)
                n_flop = 2 * dia.numel()
                lib, layout, lib_note = library_spmv(dia, x2, offs)
            else:
                # store, r, unf, D^-1 in, z out; per sweep one SpMV plus
                # the residual, D^-1 product and update on 3 NVp rows
                n_bytes = ((dia_pre.numel() + 3 * r2.numel() + dinv.numel())
                           * it + 4 * len(offs))
                n_flop = (sweeps * 2 * dia_pre.numel()
                          + (sweeps + 1) * 24 * NVp)
                lib, layout, lib_note = None, None, (
                    "none: no single PyTorch call computes the polynomial")
            b_ms, b_by = bound_ms(n_bytes, n_flop)
            lib_ms = None
            if lib is not None:
                y_lib = lib().reshape(NVp, 3).T
                lib_rel = float((y_lib - yp).abs().max() / yp.abs().max())
                lib_ms = device_ms(lib)
                lib_note = (f"{layout} matmul, {call_ms(lib):.4f} ms "
                           f"between CUDA events, max rel err vs plain "
                           f"{lib_rel:.3e}; " + lib_note)
            log(f"[kernel] {name} {str(dtype)[6:]}: bound {b_ms:.4f} ms by "
                f"{b_by} ({n_bytes / 1e6:.2f} MB, {n_flop / 1e6:.2f} MFLOP); "
                f"library call "
                + (f"{lib_ms:.4f} ms of device time" if lib_ms is not None
                   else "none") + f" ({lib_note.rstrip('; ')})")
            if dtype == torch.float32:
                out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=lib_ms, cold_ms=cold_ms,
                                 launches_per_call=per_call)
                if name == "dia_precond":
                    out[name].update(rows_per_cta=plan.rows, grid=plan.grid,
                                     staged_lanes=plan.staged,
                                     smem_bytes_per_cta=plan.smem_bytes)
    spill_check(device)
    return out


def golden_check(device):
    from thinshelllab_torch.engine import stepper
    from thinshelllab_torch.scenes import bench_scene

    g = np.load(GOLDEN)
    sc = bench_scene.make(cloth_N=int(g["cloth_N"]), table_n=int(g["table_n"]),
                          dtype=torch.float64, solver="cg", hess_refresh=8,
                          max_newton_iter=int(g["max_newton_iter"]),
                          fwd_tol=float(g["fwd_tol"]))
    spec, s0, params = sc.to(device, torch.float64)
    s0 = s0.replace(pos=torch.as_tensor(g["pos0"], device=device))
    T = g["pos"].shape[0] - 1
    _, buf = stepper.simulate(spec, params, s0,
                              bench_actions(T, torch.float64, device))
    err = float(np.abs(buf["pos"].cpu().numpy() - g["pos"]).max())
    log(f"[golden] f64 cloth_N={int(g['cloth_N'])} T={T} with kernels vs the "
        f"JAX positions: max |dpos| {err:.3e} m (tol {GOLDEN_ATOL:.0e})")
    if not err <= GOLDEN_ATOL:
        raise AssertionError(f"golden rollout off by {err:.3e} m")


def golden_adjoint_check(device):
    """The small f64 scene's forward and default backward with the kernels
    against the JAX package's gradients (the bench's no-tape path)."""
    from thinshelllab_torch.engine import adjoint, stepper
    from thinshelllab_torch.ops import dia_spmv as K
    from thinshelllab_torch.scenes import bench_scene

    g = np.load(GOLDEN_ADJ)
    sc = bench_scene.make(cloth_N=int(g["cloth_N"]), table_n=int(g["table_n"]),
                          dtype=torch.float64, solver="cg", hess_refresh=8,
                          max_newton_iter=int(g["max_newton_iter"]),
                          fwd_tol=float(g["fwd_tol"]),
                          adj_tol=float(g["adj_tol"]))
    spec, s0, params = sc.to(device, torch.float64)
    s0 = s0.replace(pos=torch.as_tensor(g["pos0"], device=device))
    dpos = torch.as_tensor(g["dpos"], device=device)
    T = dpos.shape[0]
    acts = (dpos, torch.zeros_like(dpos),
            torch.zeros((T, 1), dtype=torch.float64, device=device))
    K.reset_launches()
    _, buf = stepper.simulate(spec, params, s0, acts)
    seeds = sc.seed_loss(buf)
    res = adjoint.backward(spec, params, buf, *seeds)
    iters = adjoint.backward(spec, params, buf, *seeds,
                             debug_iters=True).pos_grad0.cpu().numpy()
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    pos_err = float(np.abs(buf["pos"].cpu().numpy() - g["pos"]).max())
    gg, pg0 = res.gripper_grad.cpu().numpy(), res.pos_grad0.cpu().numpy()
    gg_rel = float(np.abs(gg - g["gripper_grad"]).max()
                   / np.abs(g["gripper_grad"]).max())
    pg_rel = float(np.abs(pg0 - g["pos_grad0"]).max()
                   / np.abs(g["pos_grad0"]).max())
    d_it = int(np.abs(iters.astype(np.int64) - g["iters"]).max())
    nonzero = int((np.abs(gg).max(axis=(1, 2)) > 0).sum())
    log(f"[golden-adjoint] f64 cloth_N={int(g['cloth_N'])} T={T}, pad "
        f"{float(g['dpos'][0, 0, 2]) * 1e3:.1f} mm a step, forward + default "
        f"backward with kernels vs JAX: max |dpos| {pos_err:.3e} m (tol "
        f"{GOLDEN_ATOL:.0e}); gripper_grad max rel err {gg_rel:.3e}, "
        f"pos_grad0 {pg_rel:.3e} (tol {GOLDEN_ADJ_RTOL:.0e}); GMRES iters "
        f"{iters.tolist()} vs JAX {g['iters'].tolist()}; {nonzero} steps "
        f"with a gripper gradient; launches {launches}")
    if not (pos_err <= GOLDEN_ATOL and gg_rel <= GOLDEN_ADJ_RTOL
            and pg_rel <= GOLDEN_ADJ_RTOL):
        raise AssertionError("the small adjoint disagrees with the JAX golden "
                             "gradients")
    if d_it > 2 or nonzero < 3 or launches["dia_spmv"] <= 0:
        raise AssertionError(f"golden adjoint: iteration counts off by {d_it},"
                             f" {nonzero} non-zero steps, launches {launches}")


def rollout(spec, s0, params, device, T=None, dz=None):
    from thinshelllab_torch.engine import stepper

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, buf = stepper.simulate(spec, params, s0,
                              bench_actions(T or T_STEPS, spec.dtype, device,
                                            dz),
                              stats=stats)
    torch.cuda.synchronize()
    return buf, stats, time.perf_counter() - t0


def backward(sc, spec, params, buf, **kw):
    """seed_loss and adjoint.backward on a forward tape: (result, seconds)."""
    from thinshelllab_torch.engine import adjoint

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = adjoint.backward(spec, params, buf, *sc.seed_loss(buf), **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def gmres_residuals(fn):
    """Run fn() with every GMRES solve's iterations and final relative true
    residual |b - A x| / |b| recorded (one extra operator apply a solve):
    (fn's result, [(iterations, residual), ...] in sweep order)."""
    from thinshelllab_torch.engine import solver

    loop, out = solver._gmres_loop, []

    def logged(A, M, b, tol, m, max_total=None, x0=None, return_iters=False):
        x, it = loop(A, M, b, tol, m, max_total, x0=x0, return_iters=True)
        rel = torch.linalg.vector_norm(b - A(x)) / torch.linalg.vector_norm(b)
        out.append((it, float(f"{float(rel):.2e}")))
        return (x, it) if return_iters else x

    solver._gmres_loop = logged
    try:
        return fn(), out
    finally:
        solver._gmres_loop = loop


def rel_err(a, b):
    """max |a - b| / max |b| (max |a| where b is all zero)."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / (scale if scale > 0 else 1.0)


def adjoint_phase(sc, spec, params, buf, fwd_secs, device):
    """The bench backward at full size in f32 on the [main] tape: a
    warm-up backward (its gradients are the kernel path's), a timed one
    with debug_iters, the plain path on the same tape, and the same tape
    in f64 (printed, not gated)."""
    from thinshelllab_torch.ops import dia_spmv as K

    (res, _), resid = gmres_residuals(  # warm-up
        lambda: backward(sc, spec, params, buf))
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    res_t, secs = backward(sc, spec, params, buf, debug_iters=True)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    iters = res_t.pos_grad0.cpu().tolist()
    gg, pg0 = res.gripper_grad, res.pos_grad0
    if (tuple(gg.shape) != (T_STEPS + 1, 1, 6)
            or pg0.shape != buf["pos"][0].shape):
        raise AssertionError(f"gradient shapes {tuple(gg.shape)}, "
                             f"{tuple(pg0.shape)}")
    if gg.dtype != torch.float32 or pg0.dtype != torch.float32:
        raise AssertionError(f"gradient types {gg.dtype}, {pg0.dtype}")
    if not all(bool(torch.isfinite(v).all()) for v in (gg, pg0)):
        raise AssertionError("non-finite gradients in the main backward")
    if not float(pg0.abs().max()) > 0:
        raise AssertionError("the residual dL/dx_0 is zero")
    nonzero = int((gg.abs().amax(dim=(1, 2)) > 0).sum())
    if launches["dia_spmv"] <= 0 or launches["dia_precond"] != 0:
        raise AssertionError(f"backward launches {launches}: dia_spmv must "
                             "run and dia_precond must not")
    n_it = sum(iters)
    # the kernel path twice: atomic scatter-adds sum in another order
    rerun = rel_err(backward(sc, spec, params, buf)[0].pos_grad0, pg0)
    log(f"[adjoint] f32 T={T_STEPS} backward with kernels on the [main] "
        f"tape: {secs:.3f} s; fwd+bwd {T_STEPS / (fwd_secs + secs):.4f} "
        f"steps/s (forward {fwd_secs:.3f} s); GMRES iters per step "
        f"(t = {T_STEPS}..1) {iters}, {n_it} in all; launches {launches}, "
        f"{launches['dia_spmv'] / n_it:.3f} dia_spmv per GMRES iteration; "
        f"peak memory {peak / 2**20:.1f} MiB; {nonzero} steps with a gripper "
        f"gradient, max |gripper_grad| {float(gg.abs().max()):.4e}, max "
        f"|pos_grad0| {float(pg0.abs().max()):.4e}; kernel path run twice: "
        f"pos_grad0 {rerun:.3e}; {contact_gap(sc, buf)}; GMRES (iterations, "
        f"final relative residual) per step in the warm-up: {resid}")

    spec_p = spec.replace(spmv="plain")
    K.reset_launches()
    res_p, secs_p = backward(sc, spec_p, params, buf)
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"plain backward launched kernels: {K.LAUNCHES}")
    e_gg = rel_err(gg, res_p.gripper_grad)
    e_pg = rel_err(pg0, res_p.pos_grad0)
    log(f"[adjoint] f32 plain path on the same tape: {secs_p:.3f} s; kernels "
        f"vs plain max rel err gripper_grad {e_gg:.3e}, pos_grad0 "
        f"{e_pg:.3e} (tol {ADJ_PLAIN_RTOL:.0e})")
    if not (e_gg <= ADJ_PLAIN_RTOL and e_pg <= ADJ_PLAIN_RTOL):
        raise AssertionError("kernel and plain backwards disagree")

    f64_check(sc, params, buf, res, device, "[adjoint-f64]")
    return launches, secs


def f64_check(sc, params, buf, res, device, tag):
    """The same tape cast to f64, backward with kernels: the f32 backward's
    own error (printed, not gated)."""
    spec64, _, params64 = sc.to(device, torch.float64)
    buf64 = {k: v.double() if v.is_floating_point() else v
             for k, v in buf.items()}
    (res64, secs64), resid = gmres_residuals(
        lambda: backward(sc, spec64, params64, buf64))
    log(f"{tag} f64 backward with kernels on the same tape: {secs64:.3f} s; "
        f"the f32 backward's max rel err against it: gripper_grad "
        f"{rel_err(res.gripper_grad.double(), res64.gripper_grad):.3e}, "
        f"pos_grad0 {rel_err(res.pos_grad0.double(), res64.pos_grad0):.3e} "
        f"(printed, not gated); GMRES (iterations, final relative residual) "
        f"per step: {resid}")


def contact_gap(sc, buf):
    """Where the pad's lowest vertex is against the cloth, per step."""
    b, pos = sc.builder, buf["pos"]
    (cs, ce), (ps, pe) = b.vrange(0), b.vrange(2)
    return ("pad lowest z minus cloth highest z (mm) per step: " + str([
        round(float(p[ps:pe, 2].min() - p[cs:ce, 2].max()) * 1e3, 3)
        for p in pos]))


def press_phase(sc, spec, s0, params, device):
    """The full-size f32 forward+backward with the pad pressing PRESS_Z a
    step: the gripper gradient is non-zero, and the kernel and plain
    backwards agree on it."""
    from thinshelllab_torch.ops import dia_spmv as K

    buf, stats, secs = rollout(spec, s0, params, device, T_PRESS, PRESS_Z)
    K.reset_launches()
    res, secs_b = backward(sc, spec, params, buf)
    launches = dict(K.LAUNCHES)
    (res_p, _), resid = gmres_residuals(
        lambda: backward(sc, spec.replace(spmv="plain"), params, buf))
    gg, pg0 = res.gripper_grad, res.pos_grad0
    nonzero = int((gg.abs().amax(dim=(1, 2)) > 0).sum())
    e_gg = rel_err(gg, res_p.gripper_grad)
    e_pg = rel_err(pg0, res_p.pos_grad0)
    log(f"[adjoint-press] f32 T={T_PRESS}, pad {PRESS_Z * 1e3:.1f} mm a step: "
        f"forward {secs:.3f} s (CG iters {stats['cg_iters']}), backward "
        f"{secs_b:.3f} s, launches {launches}; {nonzero} steps with a gripper "
        f"gradient, max |gripper_grad| {float(gg.abs().max()):.4e}; kernels "
        f"vs plain max rel err gripper_grad {e_gg:.3e}, pos_grad0 {e_pg:.3e} "
        f"(tol {ADJ_PLAIN_RTOL:.0e}); {contact_gap(sc, buf)}; GMRES "
        f"(iterations, final relative residual) per step, plain path: "
        f"{resid}")
    if not all(bool(torch.isfinite(v).all()) for v in (gg, pg0)):
        raise AssertionError("non-finite gradients in the pressing backward")
    if nonzero < 1 or launches["dia_spmv"] <= 0:
        raise AssertionError("the pressing backward has no gripper gradient")
    if not (e_gg <= ADJ_PLAIN_RTOL and e_pg <= ADJ_PLAIN_RTOL):
        raise AssertionError("kernel and plain pressing backwards disagree")
    f64_check(sc, params, buf, res, device, "[adjoint-press-f64]")


class PhaseTimer:
    """Inclusive wall time per wrapped function, with a synchronize() on
    both sides of each call (so the phases cost more than they do
    unwrapped, and nested phases are counted in their callers too)."""

    def __init__(self):
        self.ms, self.calls, self._orig = {}, {}, []

    def timed(self, fn, label):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            self.ms[label] = self.ms.get(label, 0.0) + (
                time.perf_counter() - t0) * 1e3
            self.calls[label] = self.calls.get(label, 0) + 1
            return out

        return run

    def wrap(self, owner, name, label, factory=False):
        """Time owner.name, or with factory=True the function it returns."""
        fn = getattr(owner, name)
        setattr(owner, name, (lambda *a, **k: self.timed(fn(*a, **k), label))
                if factory else self.timed(fn, label))
        self._orig.append((owner, name, fn))

    def restore(self):
        for owner, name, fn in reversed(self._orig):
            setattr(owner, name, fn)
        self._orig = []

    def report(self, tag):
        for label, ms in sorted(self.ms.items(), key=lambda kv: -kv[1]):
            n = self.calls[label]
            log(f"[phases] {tag} {label}: {ms:.1f} ms, {n} calls, "
                f"{ms / n:.3f} ms per call")
        self.ms, self.calls = {}, {}


def phase_timers(sc, spec, s0, params, device):
    """One more forward + backward with a synchronize() around each phase."""
    from thinshelllab_torch.engine import (adjoint, elements, gridsolve,
                                           solver, stepper)
    from thinshelllab_torch.ops import spd

    pt = PhaseTimer()
    fwd = [(elements, "all_groups", "element Hessians (all_groups)"),
           (solver, "_solve_cg_prepared_T", "PCG solve"),
           (elements, "total_energy", "total_energy"),
           (stepper, "build_contacts", "contacts"),
           (elements, "assemble_residual", "assemble_residual"),
           (solver, "prepare_solver_state", "operator build")]
    bwd = [(adjoint, "_rebuild_contact", "contact rebuild"),
           (elements, "all_groups", "element Hessians (all_groups)"),
           (solver, "prepare_solver_state", "operator build"),
           (spd, "abs_inv_3x3", "|D|^-1 blocks"),
           (gridsolve, "add_contact_couplings", "contact couplings"),
           (gridsolve.GridPreconditioner, "__init__", "BCR factor"),
           (gridsolve, "extract_cloth_tridiag", "BCR factor: tridiagonal"),
           (gridsolve, "factor_tridiag", "BCR factor: reduction"),
           (gridsolve, "_safe_inv", "BCR factor: block inverses"),
           (solver, "_gmres_loop", "GMRES loop"),
           (elements, "hvp_dia", "operator apply (hvp_dia)"),
           (gridsolve.GridPreconditioner, "apply", "BCR apply"),
           (elements, "frozen_column_product", "frozen-column product"),
           (adjoint, "_contact_energy_backprop", "contact chain"),
           (adjoint, "_hinge_grads", "hinge gradients")]
    try:
        for owner, name, label in fwd:
            pt.wrap(owner, name, label)
        pt.wrap(elements, "linesearch_ef_fn", "line-search trial",
                factory=True)
        buf, _, secs = rollout(spec, s0, params, device)
        pt.restore()
        pt.report(f"forward ({secs:.3f} s with the syncs):")
        for owner, name, label in bwd:
            pt.wrap(owner, name, label)
        _, secs = backward(sc, spec, params, buf)
        pt.restore()
        pt.report(f"backward ({secs:.3f} s with the syncs):")
    finally:
        pt.restore()


def traced(fn):
    """fn() under torch.profiler: (fn's result, wall s, device us, kernel
    launches, {DIA kernel: (us, launches)}, the 6 largest entries)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total_us, total_n, mine, top = 0.0, 0, {}, []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        total_us += us
        total_n += e.count
        top.append((us, e.count, e.key[:60]))
        for k in ("dia_spmv_kernel", "dia_precond_kernel"):
            if k in e.key:
                a, n = mine.get(k, (0.0, 0))
                mine[k] = (a + us, n + e.count)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return out, wall, total_us, total_n, mine, sorted(top)[::-1][:6]


def report_trace(tag, wall, total_us, total_n, mine, top=()):
    shares = ", ".join(f"{k} {us / 1e3:.2f} ms over {n} launches = "
                       f"{us / total_us:.4f} of device time"
                       for k, (us, n) in sorted(mine.items()))
    log(f"{tag} under the profiler: wall {wall:.3f} s, device time "
        f"{total_us / 1e3:.1f} ms over {total_n} kernel launches, busy "
        f"share {total_us / 1e6 / wall:.4f}; {shares or 'no DIA kernel'}")
    for us, n, key in top:
        log(f"{tag}: {us / 1e3:.2f} ms over {n} launches: {key}")


def profile_phase(sc, spec, s0, params, device):
    """One forward and one backward of T_PROFILE steps, each under
    torch.profiler: device time, launches, busy share, and each kernel's
    share of the device time."""
    buf, *fwd = traced(lambda: rollout(spec, s0, params, device,
                                       T=T_PROFILE)[0])
    _, *bwd = traced(lambda: backward(sc, spec, params, buf))
    tag = f"[profile] f32 T={T_PROFILE}"
    report_trace(f"{tag} forward", *fwd)
    report_trace(f"{tag} backward", *bwd)
    both = {k: tuple(a + b for a, b in zip(fwd[3].get(k, (0.0, 0)),
                                          bwd[3].get(k, (0.0, 0))))
            for k in set(fwd[3]) | set(bwd[3])}
    report_trace(f"{tag} forward + backward", fwd[0] + bwd[0],
                 fwd[1] + bwd[1], fwd[2] + bwd[2], both)


def full_newton_phase(device):
    """The full-size bench forward on the full-Newton branch
    (hess_refresh=1: Hessian, operator and PCG every Newton iteration, an
    energy-only line search) through both kernels, 2 steps."""
    from thinshelllab_torch.ops import dia_spmv as K
    from thinshelllab_torch.scenes import bench_scene

    sc = bench_scene.make(cloth_N=70, table_n=12, dtype=torch.float32,
                          hess_refresh=1, fwd_tol=1e-3, max_newton_iter=8)
    spec, s0, params = sc.to(device, torch.float32)
    K.reset_launches()
    buf, stats, secs = rollout(spec, s0, params, device, T=2)
    launches = dict(K.LAUNCHES)
    log(f"[full-newton] bench f32 T=2 hess_refresh=1: {secs:.3f} s, Newton "
        f"iters {stats['newton_iters']}, operator builds "
        f"{stats['hess_builds']}, CG iters {stats['cg_iters']}, line-search "
        f"trials {stats['ls_trials']}, launches {launches}")
    if not bool(torch.isfinite(buf["pos"]).all()):
        raise AssertionError("non-finite positions on the full-Newton branch")
    if stats["hess_builds"] != stats["newton_iters"] or min(
            launches.values()) <= 0:
        raise AssertionError(f"full-Newton branch: stats {stats}, launches "
                             f"{launches}")
    return launches


def folding_golden_check(device):
    """The small f64 folding trajopt (TrajOptDriver, dense solve, plastic
    rest angles) against the JAX package's saved run."""
    from thinshelllab_torch.scenes import folding
    from thinshelllab_torch.train.trajopt import TrajOptDriver

    g = np.load(GOLDEN_FOLD)
    sc = folding.make(table_n=int(g["table_n"]),
                      max_newton_iter=int(g["max_newton_iter"]),
                      dtype=torch.float64)
    T = int(g["T"])
    drv = TrajOptDriver(sc, T, lr=float(g["lr"]),
                        max_dist=float(g["max_dist"]), device=device)
    t0 = time.perf_counter()
    infos = [drv.iteration() for _ in range(len(g["rewards"]))]
    secs = time.perf_counter() - t0
    buf = infos[0]["buffers"]
    pos_err = float(np.abs(buf["pos"].cpu().numpy() - g["pos"]).max())
    ref_err = float(np.abs(buf["ref_angle"].cpu().numpy()
                           - g["ref_angle"]).max())
    gate_ok = bool(np.array_equal(buf["yield_gate"].cpu().numpy(),
                                  g["yield_gate"]))
    rewards = np.asarray(drv.history)
    rew_rel = float((np.abs(rewards - g["rewards"])
                     / np.abs(g["rewards"])).max())
    gg = infos[0]["gripper_grad"].cpu().numpy()
    gg_rel = float(np.abs(gg - g["gripper_grad"]).max()
                   / np.abs(g["gripper_grad"]).max())
    traj_err = float(np.abs(drv.agent.traj - g["traj"]).max())
    log(f"[folding-golden] f64 table_n={int(g['table_n'])} T={T}, "
        f"{len(rewards)} TrajOptDriver iterations on the card in "
        f"{secs:.2f} s vs the JAX run: max |dpos| {pos_err:.3e} m (tol "
        f"{FOLD_POS_ATOL:.0e}), ref_angle {ref_err:.3e} rad (tol "
        f"{FOLD_REF_ATOL:.0e}), yield_gate equal {gate_ok}, rewards "
        f"{rewards.tolist()} max rel err {rew_rel:.3e} (tol "
        f"{FOLD_REWARD_RTOL:.0e}), gripper_grad max rel err {gg_rel:.3e} "
        f"(tol {FOLD_GRAD_RTOL:.0e}), waypoint table after the Adam steps "
        f"max |d| {traj_err:.3e} m (tol {FOLD_TRAJ_ATOL:.0e}); Newton "
        f"iterations per step {infos[0]['stats']['newton_per_step']}")
    if not (pos_err <= FOLD_POS_ATOL and ref_err <= FOLD_REF_ATOL and gate_ok
            and rew_rel <= FOLD_REWARD_RTOL and gg_rel <= FOLD_GRAD_RTOL
            and traj_err <= FOLD_TRAJ_ATOL):
        raise AssertionError("the small folding trajopt disagrees with the "
                             "JAX golden run")


def folding_trajopt(device):
    """The published folding scene in f32 as the CLI builds it on a card,
    FOLD_ITERS TrajOptDriver iterations at T=FOLD_T: (scene, driver, the
    first iteration's info)."""
    from thinshelllab_torch.ops import dia_spmv as K
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.trajopt import TrajOptDriver

    t0 = time.perf_counter()
    sc = registry.make_scene("folding", solver="auto", dtype=torch.float32)
    s = sc.spec
    log(f"[folding-trajopt] scene built on the host in "
        f"{time.perf_counter() - t0:.2f} s: NV {s.NV} ({3 * s.NV} DOF), "
        f"solver '{s.solver}' (from 'auto'), {s.dtype}, contact capacity "
        f"{s.contact.capacity}, hinges {s.cloth.hinge_verts.shape[0]}, tets "
        f"{s.neo.tets.shape[0]} + {s.tact.tets.shape[0]}, newton_tol "
        f"{s.newton_tol}, max_newton_iter {s.max_newton_iter}")
    if s.solver != "dense":
        raise AssertionError(f"folding resolved to solver '{s.solver}'")
    drv = TrajOptDriver(sc, FOLD_T, lr=1e-3, max_dist=0.015, device=device)
    K.reset_launches()
    first = None
    for i in range(FOLD_ITERS):
        torch.cuda.reset_peak_memory_stats(device)
        info = drv.iteration()
        peak = torch.cuda.max_memory_allocated(device)
        st, per = info["stats"], info["stats"]["newton_per_step"]
        at_cap = sum(n >= s.max_newton_iter for n in per)
        log(f"[folding-trajopt] f32 T={FOLD_T} iter {i}: forward "
            f"{info['forward_s']:.3f} s, backward {info['backward_s']:.3f} s; "
            f"Newton iterations per step mean {np.mean(per):.2f}, max "
            f"{max(per)}, {at_cap} of {len(per)} steps at the cap, "
            f"{st['newton_iters']} in all; line-search trials "
            f"{st['ls_trials']}; peak memory {peak / 2**20:.1f} MiB; per "
            f"step {per}")
        log(f"iter {i}: reward {info['reward']:.6f} |g| "
            f"{info['grad_norm']:.4g} t {info['wall_time']:.2f}s")
        gg = info["gripper_grad"]
        if not (np.isfinite(info["reward"]) and bool(torch.isfinite(gg).all())
                and info["grad_norm"] > 0):
            raise AssertionError(f"folding iteration {i}: reward "
                                 f"{info['reward']}, |g| {info['grad_norm']}")
        if first is None:
            first = info
    launches = dict(K.LAUNCHES)
    log(f"[folding-trajopt] DIA kernel launches over the {FOLD_ITERS} "
        f"iterations: {launches} (the dense solve uses none)")
    return sc, drv, first


def folding_f32_adjoint(sc, info, device):
    """The first iteration's f32 tape cast to f64 and its backward: the
    f32 gripper gradient's error."""
    from thinshelllab_torch.engine import adjoint

    buf = info["buffers"]
    spec64, _, params64 = sc.to(device, torch.float64)
    buf64 = {k: v.double() if v.is_floating_point() else v
             for k, v in buf.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res64 = adjoint.backward(spec64, params64, buf64, *sc.seed_loss(buf64))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    g32, g64 = info["gripper_grad"].double(), res64.gripper_grad
    err = float(torch.linalg.vector_norm(g32 - g64)
                / torch.linalg.vector_norm(g64))
    worst = int((g32 - g64).abs().amax(dim=(1, 2)).argmax())
    log(f"[folding-f32-adjoint] f64 backward on the first iteration's f32 "
        f"tape: {secs:.3f} s; the f32 gripper_grad's error against it "
        f"|g32 - g64| / |g64| {err:.3e} (tol {FOLD_F32_RTOL:.0e}), max "
        f"|g32 - g64| / max |g64| {rel_err(g32, g64):.3e} (printed, not "
        f"gated; largest at step {worst}: f32 {g32[worst, 0].tolist()}, f64 "
        f"{g64[worst, 0].tolist()}); |g| f32 {float(info['grad_norm']):.6g},"
        f" f64 {float(torch.linalg.vector_norm(g64)):.6g}")
    if not err <= FOLD_F32_RTOL:
        raise AssertionError(f"f32 folding gradient off by {err:.3e}")


def folding_phases(sc, drv, device):
    """FOLD_PHASE_STEPS steps of the driver's current waypoint table:
    forward + backward under phase timers, the f32 reward of one more run
    of that rollout, and the backward and a forward step cut to
    FOLD_PROFILE_NEWTON Newton iterations under the profiler."""
    from thinshelllab_torch.engine import adjoint, elements, solver, stepper
    from thinshelllab_torch.ops import spd

    acts = tuple(a[:FOLD_PHASE_STEPS] for a in drv.agent.actions())
    tag = f"f32 {FOLD_PHASE_STEPS} steps"
    pt = PhaseTimer()
    fwd = [(elements, "all_groups", "element Hessians (all_groups)"),
           (spd, "project_psd", "eigh projection (project_psd)"),
           (elements, "dense_hessian", "dense_hessian"),
           (solver, "solve_dense", "dense solve (dense_hessian + LU)"),
           (elements, "total_energy", "total_energy"),
           (stepper, "build_contacts", "contacts"),
           (elements, "assemble_residual", "assemble_residual")]
    bwd = [(adjoint, "_rebuild_contact", "contact rebuild"),
           (elements, "all_groups", "element Hessians (all_groups)"),
           (elements, "dense_hessian", "dense_hessian"),
           (solver, "solve_dense", "dense solve (dense_hessian + LU)"),
           (elements, "frozen_column_product", "frozen-column product"),
           (adjoint, "_contact_energy_backprop", "contact chain"),
           (adjoint, "_hinge_grads", "hinge gradients (plastic chain)"),
           (adjoint, "_gather_gripper_grad", "gripper gradient gather")]
    try:
        for owner, name, label in fwd:
            pt.wrap(owner, name, label)
        pt.wrap(elements, "linesearch_energy_fn", "line-search trial",
                factory=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, buf = drv.forward(acts)
        torch.cuda.synchronize()
        pt.restore()
        pt.report(f"folding forward {tag} ({time.perf_counter() - t0:.3f} s "
                  f"with the syncs):")
        for owner, name, label in bwd:
            pt.wrap(owner, name, label)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        drv.backward(buf, *sc.seed_loss(buf))
        torch.cuda.synchronize()
        pt.restore()
        pt.report(f"folding backward {tag} ({time.perf_counter() - t0:.3f} s "
                  f"with the syncs):")
    finally:
        pt.restore()
    buf2 = drv.forward(acts)[1]
    rewards = [float(sc.reward(b)) for b in (buf, buf2)]
    dpos = float((buf2["pos"] - buf["pos"]).abs().max())
    log(f"[folding-spread] {tag}, the same actions twice: rewards "
        f"{rewards}, difference {rewards[1] - rewards[0]:.3e}; max |dpos| "
        f"between the runs {dpos:.3e} m")
    # the profiler's trace of a whole step (~600,000 launches) takes minutes
    # to read back: the first step with the Newton cap cut instead
    spec_p = drv.spec.replace(max_newton_iter=FOLD_PROFILE_NEWTON)
    acts1 = tuple(a[:1] for a in acts)
    _, *fw = traced(lambda: stepper.simulate(spec_p, drv.params, drv.state0,
                                             acts1))
    _, *bw = traced(lambda: drv.backward(buf, *sc.seed_loss(buf)))
    report_trace(f"[folding-profile] f32 1 step, {FOLD_PROFILE_NEWTON} Newton "
                 f"iterations, forward", *fw)
    report_trace(f"[folding-profile] {tag} backward", *bw)


def scene_state(name, sc, device):
    """Balancing starts from the bundled pre-grasped state, as `cli
    trajopt` does; every other scene from its own initial state."""
    from thinshelllab_torch.scenes import balancing
    from thinshelllab_torch.utils import checkpoint

    if name == "balancing":
        sc.state0 = checkpoint.load_state(balancing.bundled_state_path(),
                                          sc.spec.dtype, device)
    return sc


def scene_actions(n_part, T, dtype, device):
    dpos = torch.zeros((T, n_part, 3), dtype=dtype, device=device)
    dpos[:, :, 2] = SCENE_DZ
    return (dpos, torch.zeros((T, n_part, 3), dtype=dtype, device=device),
            torch.zeros((T, n_part), dtype=dtype, device=device))


def scene_run(sc, spec, s0, params, T, buf=None):
    """Forward (unless a tape is given) and the default seed's backward:
    (buffers, AdjointResult, solver stats, forward s, backward s)."""
    from thinshelllab_torch.engine import adjoint, stepper

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if buf is None:
        acts = scene_actions(sc.n_part, T, spec.dtype, s0.pos.device)
        _, buf = stepper.simulate(spec, params, s0, acts, stats=stats,
                                  save_contacts=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = adjoint.backward(spec, params, buf, *sc.seed_loss(buf),
                           with_param_grad=sc.sys_param is not None)
    torch.cuda.synchronize()
    return buf, res, stats, t1 - t0, time.perf_counter() - t1


def scenes_golden_check(device):
    """The CPU tests' small f64 runs of every new scene on the card against
    the JAX package's saved runs (tests/data/scenes_golden.npz)."""
    from thinshelllab_torch.core.convert import (golden_grad_errors,
                                                 tape_from_entries)
    from thinshelllab_torch.engine import stepper
    from thinshelllab_torch.scenes import registry

    z = np.load(GOLDEN_SCENES)
    for name in NEW_SCENES:
        g = {k[len(name) + 1:]: z[k] for k in z.files
             if k.startswith(name + ".")}
        sc = scene_state(name, registry.make_scene(
            name, solver="auto", max_newton_iter=SCENE_GOLDEN_NEWTON,
            dtype=torch.float64), device)
        spec, s0, params = sc.to(device)
        buf, res, stats, fs, bs = scene_run(sc, spec, s0, params,
                                            SCENE_GOLDEN_T)
        pos_err = float(np.abs(buf["pos"].cpu().numpy() - g["pos"]).max())
        gg_rel, pg_rel, sys_rel = golden_grad_errors(res, g, sc.sys_param)
        line = (f"[scenes-golden] {name} f64 T={SCENE_GOLDEN_T} "
                f"max_newton_iter={SCENE_GOLDEN_NEWTON} vs the JAX run "
                f"({fs:.2f} s + {bs:.2f} s): max |dpos| {pos_err:.3e} m, "
                f"gripper_grad rel err {gg_rel:.3e}, param_grad {pg_rel:.3e}"
                f", sys_param {sys_rel:.3e}; Newton per step "
                f"{stats['newton_per_step']}")
        if name in SCENE_TIES:
            tape = tape_from_entries(g, device)
            acts = scene_actions(sc.n_part, SCENE_GOLDEN_T, spec.dtype,
                                 device)
            replay = [float((stepper.replay_step(
                spec, params, tape, t, tuple(a[t] for a in acts), s0.vel)
                - tape["pos"][t + 1]).abs().max())
                for t in range(SCENE_GOLDEN_T)]
            _, rt, _, _, bt = scene_run(sc, spec, s0, params, SCENE_GOLDEN_T,
                                        buf=tape)
            t_gg, t_pg, t_sys = golden_grad_errors(rt, g, sc.sys_param)
            log(f"{line} (not gated: {SCENE_TIES[name]}, ROADMAP.md §3); "
                f"each step replayed from the JAX state with the JAX "
                f"contact set: max |dpos| "
                f"{', '.join(f'{e:.3e}' for e in replay)} m (tol "
                f"{SCENE_POS_ATOL:.0e}); backward on the JAX tape ({bt:.2f} "
                f"s): gripper_grad {t_gg:.3e}, param_grad {t_pg:.3e}, "
                f"sys_param {t_sys:.3e} (tol {SCENE_GRAD_RTOL:.0e})")
            if not max(replay) <= SCENE_POS_ATOL:
                raise AssertionError(f"{name}: a step replayed on the JAX "
                                     "tape disagrees with the JAX positions")
            if not max(t_gg, t_pg, t_sys) <= SCENE_GRAD_RTOL:
                raise AssertionError(f"{name}: the backward on the JAX tape "
                                     "disagrees with the JAX gradients")
            continue
        log(f"{line} (tol {SCENE_POS_ATOL:.0e} m, {SCENE_GRAD_RTOL:.0e})")
        if not (pos_err <= SCENE_POS_ATOL
                and max(gg_rel, pg_rel, sys_rel) <= SCENE_GRAD_RTOL):
            raise AssertionError(f"{name} disagrees with the JAX golden run")


def scenes_phase(device):
    """Every new scene at its published size and Newton cap in f64 on the
    card: SCENES_T steps forward, the default seed, the backward."""
    from thinshelllab_torch.ops import dia_spmv as K
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train import dp

    for name in NEW_SCENES:
        sc = scene_state(name, registry.make_scene(name, solver="auto",
                                                   dtype=torch.float64),
                         device)
        s = sc.spec
        spec, s0, params = sc.to(device)
        K.reset_launches()
        buf, res, stats, fs, bs = scene_run(sc, spec, s0, params, SCENES_T)
        launches = sum(K.LAUNCHES.values())
        per = stats["newton_per_step"]
        at_cap = sum(n >= s.max_newton_iter for n in per)
        pos = buf["pos"]
        disp = float((pos[-1] - pos[0]).abs().max())
        gg = float(res.gripper_grad.abs().max())
        pg = (abs(float(dp._get_param(res.param_grad, sc.sys_param)))
              if sc.sys_param else float("nan"))
        reward = float(sc.reward(buf))
        log(f"[scenes] {name}: NV {s.NV} ({3 * s.NV} DOF), solver "
            f"'{s.solver}', f64 T={SCENES_T}; Newton per step {per} ({at_cap}"
            f" of {len(per)} at the cap {s.max_newton_iter}); forward "
            f"{fs:.3f} s, backward {bs:.3f} s; reward {reward:.6g}; max "
            f"|gripper_grad| {gg:.4g}; |param_grad| of "
            f"{sc.sys_param} {pg:.4g}; max displacement {disp:.3e} m; DIA "
            f"kernel launches {launches}")
        finite = bool(torch.isfinite(res.gripper_grad).all()) and all(
            bool(torch.isfinite(getattr(res.param_grad, f.name)).all())
            for f in dataclasses.fields(res.param_grad))
        if not (bool(torch.isfinite(pos).all()) and disp < SCENE_DISP_MAX
                and finite and np.isfinite(reward)):
            raise AssertionError(f"{name}: positions finite "
                                 f"{bool(torch.isfinite(pos).all())}, "
                                 f"displacement {disp}, gradients finite "
                                 f"{finite}, reward {reward}")


def scenes_trajopt_phase(device):
    """One f32 TrajOptDriver iteration at T=SCENES_TRAJOPT_T, as `cli
    trajopt` runs it on a card, for every new scene with a gripper."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.trajopt import TrajOptDriver

    for name in NEW_SCENES:
        sc = registry.make_scene(name, solver="auto", dtype=torch.float32)
        if sc.n_part == 0:
            continue
        sc = scene_state(name, sc, device)
        drv = TrajOptDriver(sc, SCENES_TRAJOPT_T, lr=1e-3, max_dist=0.015,
                            device=device)
        info = drv.iteration()
        per = info["stats"]["newton_per_step"]
        cap = sc.spec.max_newton_iter
        log(f"[scenes-trajopt] {name} f32 T={SCENES_TRAJOPT_T}: Newton per "
            f"step {per} ({sum(n >= cap for n in per)} of {len(per)} at the "
            f"cap {cap}), line-search trials {info['stats']['ls_trials']}; "
            f"forward {info['forward_s']:.3f} s, backward "
            f"{info['backward_s']:.3f} s")
        log(f"iter 0: reward {info['reward']:.6f} |g| "
            f"{info['grad_norm']:.4g} t {info['wall_time']:.2f}s")
        if not (np.isfinite(info["reward"])
                and np.isfinite(info["grad_norm"])):
            raise AssertionError(f"{name}: reward {info['reward']}, |g| "
                                 f"{info['grad_norm']}")


def dp_phase(device):
    """System identification as `cli dp` runs it on a card (f32, solver
    auto, a zero trajectory): ParamOptDriver on bouncing's Kb, one
    ParamCMAESDriver generation on card's Kb."""
    from thinshelllab_torch.scenes import registry
    from thinshelllab_torch.train.dp import (ParamCMAESDriver,
                                             ParamOptDriver, _get_param)

    def zeros(n):
        return tuple(torch.zeros(sh, dtype=torch.float64, device=device)
                     for sh in ((DP_T - 1, n, 3), (DP_T - 1, n, 3),
                                (DP_T - 1, n)))

    sc = registry.make_scene("bouncing", solver="auto", dtype=torch.float32)
    t0 = time.perf_counter()
    drv = ParamOptDriver(sc, zeros(0), lr=DP_LR, device=device)
    for i in range(DP_ITERS):
        info = drv.iteration()
        log(f"iter {i}: reward {info['reward']:.5f} "
            f"param {info['param']:.4f} grad {info['grad']:.3g}")
        if not all(np.isfinite(v) for v in info.values()):
            raise AssertionError(f"dp bouncing: {info}")
    log(f"[dp] bouncing f32 T={DP_T}: {DP_ITERS} ParamOptDriver iterations "
        f"in {time.perf_counter() - t0:.2f} s")
    sc = registry.make_scene("card", solver="auto", dtype=torch.float32)
    t0 = time.perf_counter()
    drv = ParamCMAESDriver(sc, zeros(sc.n_part),
                           base_value=float(_get_param(sc.params, "kb")),
                           pop_size=DP_POP, device=device)
    info = drv.generation()
    log(f"gen 0: best_param {info['best_param']:.4f} "
        f"best_reward {info['best_reward']:.5f}")
    log(f"[dp] card f32 T={DP_T}: one ParamCMAESDriver generation of "
        f"{DP_POP} in {time.perf_counter() - t0:.2f} s")
    if not all(np.isfinite(v) for v in info.values()):
        raise AssertionError(f"dp card: {info}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available; the port's "
                         "smoke run needs one CUDA card")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; python "
        f"{sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    from thinshelllab_torch.ops import dia_spmv as K
    from thinshelllab_torch.scenes import bench_scene

    t0 = time.perf_counter()
    K.build(verbose=True)
    K._load()
    log(f"[build] nvcc sm_90a -> {os.path.relpath(K._LIB_PATH, ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    sc = bench_scene.make(cloth_N=70, table_n=12, dtype=torch.float32,
                          hess_refresh=8, fwd_tol=1e-3, max_newton_iter=8)
    s = sc.spec
    log(f"[scene] bench cloth_N=70 built on the host in "
        f"{time.perf_counter() - t0:.2f} s: NV {s.NV}, faces "
        f"{s.faces.shape[0]}, NVp {s.dia.NVp}, {len(s.dia.offsets)} offsets, "
        f"contact capacity {s.contact.capacity}, hinges "
        f"{s.cloth.hinge_verts.shape[0]}")

    kres = timed("kernel checks", kernel_checks, sc, device)
    timed("golden", golden_check, device)
    timed("golden-adjoint", golden_adjoint_check, device)
    t_main = time.perf_counter()

    spec, s0, params = sc.to(device, torch.float32)
    gp = spec.dev.grid_plan
    log(f"[scene] grid plan {[(N, M, v, len(l)) for N, M, v, l in gp]} "
        f"(N, M, first vertex, lanes), bcr_cutoff {spec.bcr_cutoff}, "
        f"GMRES restart {min(spec.cg_max_iter, 64)}, adjoint tol "
        f"{spec.cg_tol if spec.adj_tol is None else spec.adj_tol}")
    buf_w, _, _ = rollout(spec, s0, params, device)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    precond_calls, wrapper = [0], K.dia_precond

    def counted(*a, **k):
        precond_calls[0] += 1
        return wrapper(*a, **k)

    K.dia_precond = counted  # the CG preconditioner's calls
    try:
        K.reset_launches()
        buf, stats, secs = rollout(spec, s0, params, device)
        launches = dict(K.LAUNCHES)
    finally:
        K.dia_precond = wrapper
    peak = torch.cuda.max_memory_allocated(device)
    pos = buf["pos"]
    cloth_nv = (70 + 1) ** 2
    if pos.shape != (T_STEPS + 1, spec.NV, 3):
        raise AssertionError(f"positions have shape {tuple(pos.shape)}")
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError("non-finite positions in the main rollout")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    if launches["dia_precond"] != precond_calls[0]:
        raise AssertionError(f"{launches['dia_precond']} dia_precond launches"
                             f" for {precond_calls[0]} preconditioner calls")
    reward = float(sc.reward({"pos": pos}))
    log(f"[main] f32 T={T_STEPS} with kernels: {T_STEPS / secs:.4f} steps/s "
        f"({secs:.3f} s), Newton iters {stats['newton_iters']}, operator "
        f"builds {stats['hess_builds']}, CG iters {stats['cg_iters']}, "
        f"line-search trials {stats['ls_trials']}, CG preconditioner calls "
        f"{precond_calls[0]}, launches {launches}, peak "
        f"memory {peak / 2**20:.1f} MiB, reward -sum(z_cloth) {reward:.6f}")

    spec_p = spec.replace(spmv="plain")
    rollout(spec_p, s0, params, device)  # warm-up
    K.reset_launches()
    buf_p, stats_p, secs_p = rollout(spec_p, s0, params, device)
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"plain path launched kernels: {K.LAUNCHES}")
    disp = float((pos[-1, :cloth_nv] - pos[0, :cloth_nv]).abs().max())
    dpos = float((buf_p["pos"] - pos).abs().max())
    rel = dpos / disp
    # the kernel path twice: scatter-adds with atomics sum in another order
    # each run
    rerun = float((buf_w["pos"] - pos).abs().max()) / disp
    log(f"[plain] f32 T={T_STEPS} plain path: {T_STEPS / secs_p:.4f} steps/s "
        f"({secs_p:.3f} s), Newton iters {stats_p['newton_iters']}, CG iters "
        f"{stats_p['cg_iters']}; max |dpos| vs kernels {dpos:.3e} m = "
        f"{rel:.3e} of the largest cloth displacement {disp:.3e} m "
        f"(tol {PLAIN_VS_KERNEL_RTOL:.0e}); kernel path run twice: "
        f"{rerun:.3e}")
    if not rel <= PLAIN_VS_KERNEL_RTOL:
        raise AssertionError(f"plain and kernel rollouts differ ({rel:.3e})")

    log(f"[time] main and plain: {time.perf_counter() - t_main:.1f} s")
    launches_bwd, _ = timed("adjoint", adjoint_phase, sc, spec, params, buf,
                            secs, device)
    timed("phases", phase_timers, sc, spec, s0, params, device)
    timed("profile", profile_phase, sc, spec, s0, params, device)
    timed("adjoint-press", press_phase, sc, spec, s0, params, device)
    launches_fn = timed("full-newton", full_newton_phase, device)

    timed("folding-golden", folding_golden_check, device)
    fsc, fdrv, finfo = timed("folding-trajopt", folding_trajopt, device)
    timed("folding-f32-adjoint", folding_f32_adjoint, fsc, finfo, device)
    timed("folding-phases", folding_phases, fsc, fdrv, device)

    timed("scenes-golden", scenes_golden_check, device)
    timed("scenes", scenes_phase, device)
    timed("scenes-trajopt", scenes_trajopt_phase, device)
    timed("dp", dp_phase, device)

    src = "thinshelllab_torch/csrc/dia_spmv.cu"
    replaces = {"dia_spmv": "thinshelllab_tpu/ops/dia_spmv.py:93",
                "dia_precond": "thinshelllab_tpu/ops/dia_spmv.py:237"}
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=replaces[name],
             launches=launches[name] + launches_bwd[name],
             launches_forward=launches[name],
             launches_backward=launches_bwd[name],
             launches_full_newton=launches_fn[name], **kres[name])
        for name in ("dia_spmv", "dia_precond")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
