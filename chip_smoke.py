"""Smoke run of thinshelllab_torch on one CUDA card.

Builds the two DIA kernels (csrc/dia_spmv.cu) with nvcc, holds each against
its plain PyTorch version on the full bench scene's assembled operator,
holds a small f64 rollout against the JAX package's saved positions
(tests/data/bench8_golden.npz), then runs the bench scene's forward rollout
at full size (cloth_N=70: 5,605 vertices, 9,800 cloth triangles) in f32
with the kernels, and once more on the plain path.

    python3 chip_smoke.py

Prints one line per phase, then a JSON line of per-kernel results, the
card's `nvidia-smi` name and power limit, and as the last line
{"ok": true, "device": {...}}. Any failure raises, exits non-zero and
prints no result line. Needs CUDA; there is no CPU path.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "bench8_golden.npz")

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
T_STEPS = 8
DISPLACEMENT_Z = -4e-4  # bench.py:143-149: the pad moves 0.4 mm down a step


def log(msg):
    print(msg, flush=True)


def bench_actions(T, dtype, device):
    dpos = torch.zeros((T, 1, 3), dtype=dtype, device=device)
    dpos[:, 0, 2] = DISPLACEMENT_Z
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


def device_ms(fn, n=60):
    """Device time per call (ms): the summed time of every CUDA kernel the
    n calls ran, from the profiler's trace of the card."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / 1e3 / n


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


def kernel_checks(sc, device):
    from thinshelllab_torch.ops import dia_spmv as K

    rng = np.random.default_rng(0)
    out = {}
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
            yk, yp = kern(), plain()
            torch.cuda.synchronize()
            abs_err = float((yk - yp).abs().max())
            rel = abs_err / float(yp.abs().max())
            tol = KERNEL_RTOL[dtype]
            ms, plain_ms = device_ms(kern), device_ms(plain)
            call, plain_call = call_ms(kern), call_ms(plain)
            log(f"[kernel] {name} {str(dtype)[6:]} shape {tuple(dia.shape)}: "
                f"max rel err {rel:.3e} (tol {tol:.0e}), max abs err "
                f"{abs_err:.3e}; device time per call: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms; per call between CUDA events: "
                f"kernel {call:.4f} ms, plain {plain_call:.4f} ms (60 calls)")
            if not rel <= tol:
                raise AssertionError(f"{name} {dtype}: kernel disagrees with "
                                     f"its plain version ({rel:.3e} > {tol})")
            if dtype == torch.float32:
                out[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
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


def rollout(spec, s0, params, device):
    from thinshelllab_torch.engine import stepper

    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, buf = stepper.simulate(spec, params, s0,
                              bench_actions(T_STEPS, spec.dtype, device),
                              stats=stats)
    torch.cuda.synchronize()
    return buf, stats, time.perf_counter() - t0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available; the port's "
                         "smoke run needs one CUDA card")
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

    kres = kernel_checks(sc, device)
    golden_check(device)

    spec, s0, params = sc.to(device, torch.float32)
    buf_w, _, _ = rollout(spec, s0, params, device)  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    K.reset_launches()
    buf, stats, secs = rollout(spec, s0, params, device)
    launches = dict(K.LAUNCHES)
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
    reward = float(sc.reward({"pos": pos}))
    log(f"[main] f32 T={T_STEPS} with kernels: {T_STEPS / secs:.4f} steps/s "
        f"({secs:.3f} s), Newton iters {stats['newton_iters']}, operator "
        f"builds {stats['hess_builds']}, CG iters {stats['cg_iters']}, "
        f"line-search trials {stats['ls_trials']}, launches {launches}, peak "
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

    src = "thinshelllab_torch/csrc/dia_spmv.cu"
    replaces = {"dia_spmv": "thinshelllab_tpu/ops/dia_spmv.py:93",
                "dia_precond": "thinshelllab_tpu/ops/dia_spmv.py:237"}
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=replaces[name],
             launches=launches[name], **kres[name])
        for name in ("dia_spmv", "dia_precond")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
