"""Where the time of the dia_precond kernel goes, on one CUDA card.

Times the kernel on a random store at the bench plan's shapes (the bench
scene's 71 offsets over NVp 6144) for sweeps 0..3, with the geometry the
wrapper chooses and with variants of it (no lanes staged, so every sweep
reads the store from global memory; other rows per CTA), so that the
differences between rows give the cost of the copy into shared memory and
of one sweep with its grid barrier. A kernel of nothing but grid barriers
(scripts/grid_sync_probe.cu, built here with nvcc) is timed at the same
geometry for the cost of one barrier.

    python3 scripts/precond_breakdown.py [--dtype float32|float64] [--n 200]

Prints one line per (variant, sweeps): device time per call from
torch.profiler over n back-to-back calls, and as the last line the same as
JSON. Needs CUDA.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def kernel_ms(fn, n, key="dia_precond_kernel"):
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
             if e.device_type == torch.autograd.DeviceType.CUDA
             and key in e.key)
    return us / 1e3 / n


def grid_sync_ms(K, plan, n):
    """Device time per launch of grid_sync_probe at plan's geometry, for
    0..3 barriers: {barriers: ms}."""
    import ctypes

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "grid_sync_probe.cu")
    lib_path = os.path.join(K.BUILD_DIR, "libgrid_sync_probe.so")
    os.makedirs(K.BUILD_DIR, exist_ok=True)
    subprocess.run([K._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib_path, src], check=True)
    fn = ctypes.CDLL(lib_path).tsl_grid_sync_probe
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for syncs in range(4):
        def call():
            err = fn(plan.grid, plan.threads, plan.smem_bytes, syncs, stream)
            if err:
                raise RuntimeError(f"grid_sync_probe: CUDA error {err}")
        out[syncs] = kernel_ms(call, n, key="grid_sync_probe")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--n", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("precond_breakdown.py needs a CUDA card")
    from thinshelllab_torch.ops import dia_spmv as K
    from thinshelllab_torch.scenes import bench_scene

    dev = torch.device("cuda", 0)
    dtype = getattr(torch, args.dtype)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    offs = bench_scene.make(cloth_N=70, table_n=12).spec.dia.offsets
    NVp, n_off = 6144, len(offs)
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=dtype,
                               device=dev)

    dia, dinv, r2 = t(n_off, 3, 3, NVp), t(3, 3, NVp) * 0.1, t(3, NVp)
    unf2 = torch.ones_like(r2)
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    base = K.device_precond_plan(0, NVp, tuple(offs), dtype)
    it = dia.element_size()
    variants = {"wrapper": base, "unstaged": dataclasses.replace(
        base, staged=0)}
    _, smem_limit = K._int_out(K._load().tsl_device_limits, 0)
    for rows in (96, 64):
        v = K.precond_plan(NVp, n_off, it, -(-NVp // rows), smem_limit,
                           base.max_off)
        variants[f"rows{v.rows}"] = v
    for groups in (5, 20):  # fewer and more offset groups, same rows
        staged = base.staged
        while K.precond_smem_bytes(base.rows, groups, staged, base.max_off,
                                   n_off, it) > smem_limit:
            staged -= 1
        variants[f"groups{groups}"] = dataclasses.replace(
            base, groups=groups, threads=32 * -(-base.rows * groups // 32),
            staged=staged,
            smem_bytes=K.precond_smem_bytes(base.rows, groups, staged,
                                            base.max_off, n_off, it))
    # one CTA per SM of 4 rows: a sweep's work is a few loads a thread, so
    # a sweep costs about its grid barrier and the window's L2 round trip
    nt = 4 * base.grid
    small = (dia[:, :, :, :nt].contiguous(), r2[:, :nt].contiguous(),
             unf2[:, :nt].contiguous(), dinv[:, :, :nt].contiguous())
    variants["rows4"] = K.precond_plan(nt, n_off, it, base.grid, smem_limit,
                                       base.max_off)
    out = []
    for label, plan in variants.items():
        ins = small if label == "rows4" else (dia, r2, unf2, dinv)
        for sweeps in range(4):
            ms = kernel_ms(lambda: K._precond_launch(
                plan, ins[0], ins[1], ins[2], ins[3], offs_t, 0.8, sweeps),
                args.n)
            row = dict(variant=label, sweeps=sweeps, ms=ms, rows=plan.rows,
                       grid=plan.grid, threads=plan.threads,
                       staged=plan.staged, smem_bytes=plan.smem_bytes)
            out.append(row)
            print(f"{label:9s} sweeps {sweeps}: {ms:.4f} ms  ({plan})",
                  flush=True)
    sync_ms = grid_sync_ms(K, base, args.n)
    for syncs, ms in sync_ms.items():
        print(f"grid.sync probe, {base.grid} CTAs of {base.threads} threads,"
              f" {base.smem_bytes} B shared: {syncs} barriers: {ms:.4f} ms",
              flush=True)
    print(json.dumps({"dtype": args.dtype, "rows": out,
                      "grid_sync_probe_ms": sync_ms}))


if __name__ == "__main__":
    main()
