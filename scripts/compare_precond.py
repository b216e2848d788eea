"""The dia_precond kernel of this checkout against that of another one, on
one CUDA card, in turns (other, this, this, other).

    git archive <commit> | tar -x -C _parent   # a directory .gitignore lists
    python3 scripts/compare_precond.py --other _parent

Each checkout's `thinshelllab_torch/ops/dia_spmv.py` is loaded on its own
and builds its own kernels. Both run on one random store at the bench
plan's shapes (71 offsets over NVp 6144, 3 sweeps, w 0.8), in f32 and f64;
per call: device time of its kernels from torch.profiler, with the L2 warm
(back-to-back calls) and cold (a 64 MiB buffer written between calls),
launches, and the time between CUDA events (the host's cost included).
Prints one line per measurement and, as the last line, all of them as
JSON. Needs CUDA.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLUSH_BYTES = 64 * 2**20


def load(root, name):
    path = os.path.join(root, "thinshelllab_torch", "ops", "dia_spmv.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def device_ms(fn, n, flush=None):
    """Device time per call of every CUDA kernel fn runs (the flush's
    own kernel excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            if flush is not None:
                flush.fill_(1.0)
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if flush is not None and "fill" in e.key.lower():
            continue
        us += (getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0))
    return us / 1e3 / n


def event_ms(fn, n):
    for _ in range(5):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--n", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_precond.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sys.path.insert(0, ROOT)
    from thinshelllab_torch.scenes import bench_scene

    mods = {"other": load(os.path.abspath(args.other), "dia_spmv_other"),
            "this": load(ROOT, "dia_spmv_this")}
    offs = bench_scene.make(cloth_N=70, table_n=12).spec.dia.offsets
    dev = torch.device("cuda", 0)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rows = []
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(0)

        def t(*shape, scale=1.0):
            return torch.as_tensor(rng.normal(size=shape) * scale,
                                   dtype=dtype, device=dev)

        NVp, n_off = 6144, len(offs)
        dia, dinv = t(n_off, 3, 3, NVp), t(3, 3, NVp, scale=0.1)
        unf2 = torch.ones((3, NVp), dtype=dtype, device=dev)
        r2 = t(3, NVp)
        offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
        ref = mods["this"].dia_precond_plain(dia, r2, unf2, dinv, offs, 0.8, 3)
        for which in ("other", "this", "this", "other"):
            K = mods[which]

            def call():
                return K.dia_precond(dia, r2, unf2, dinv, offs, 0.8, 3, offs_t)

            K.reset_launches()
            z = call()
            torch.cuda.synchronize()
            launches = K.LAUNCHES["dia_precond"]
            err = float((z - ref).abs().max() / ref.abs().max())
            row = dict(checkout=which, dtype=str(dtype)[6:],
                       launches_per_call=launches, max_rel_err=err,
                       warm_ms=device_ms(call, args.n),
                       cold_ms=device_ms(call, args.n // 4, flush),
                       event_ms=event_ms(call, args.n))
            rows.append(row)
            print(f"{which:5s} {row['dtype']}: {launches} launches a call, "
                  f"device {row['warm_ms']:.4f} ms warm L2, "
                  f"{row['cold_ms']:.4f} ms cold L2; between CUDA events "
                  f"{row['event_ms']:.4f} ms; max rel err vs plain {err:.2e}",
                  flush=True)
    print(json.dumps({"rows": rows}))


if __name__ == "__main__":
    main()
