"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cell's CUDA cards. The
last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), device, with --trace 1 breakdown, and last the
numbers of the output check beside their limits, which are also the last
lines of standard error. See benchmark/README.md."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the program one precision below the "
                        "configuration's (the output check's control, "
                        "whose result must come out not correct)")
    return p.parse_args(argv)


def environment(root):
    """Every build and kernel cache inside the checkout, at fixed paths;
    one host thread for torch's and the BLAS's CPU pools. The program's
    host work is one thread launching onto the card, and idle pool threads
    spinning beside it only add noise to its timings."""
    base = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


@dataclasses.dataclass
class Ctx:
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: object
    dtype: str
    record: object


def make_ctx(man, wl_name, seed, device, traced, control=False):
    from benchmark.harness import manifest, program
    from benchmark.harness.record import Record

    wl = manifest.workload(man, wl_name)
    cfg = manifest.config(wl["config"])
    dtype = program.CONTROL_DTYPE[cfg["dtype"]] if control else cfg["dtype"]
    return Ctx(workload=wl_name, config=cfg,
               traffic=manifest.traffic(wl["traffic"]),
               limits=manifest.limits(wl_name), seed=seed, device=device,
               dtype=dtype, record=Record(traced))


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(ctx, man, seconds, t_start, chips=1):
    """Set-up, the window, the output check and the metrics of one run:
    (result dict, stderr lines). The caller has found the cards."""
    import torch

    from benchmark.harness import checks, manifest
    from benchmark.harness.window import Window

    kind = manifest.driver(ctx.traffic["kind"])
    rec = ctx.record
    layer = (manifest.per_layer_for(man, ctx.workload) if rec.traced
             else [])
    e2e = manifest.end_to_end_for(man, ctx.workload)
    readers = {m["name"]: manifest.metric_reader(m["name"])
               for m in (layer if rec.traced else e2e)}

    state = kind.setup(ctx)
    _sync(ctx.device)
    rec.setup_s = time.perf_counter() - t_start
    for r in readers.values():
        rec.install(getattr(r, "SPANS", []))
    win = Window(seconds)
    rec.window = win
    try:
        kind.run_window(state, win.open(), rec)
        _sync(ctx.device)
    finally:
        rec.restore()
    rec.reduce_trace()
    cuda = ctx.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    got = kind.release(state, rec, ctx)
    del state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = kind.check(ctx, got)
    rec.check_s = time.perf_counter() - t_check
    rec.numbers = numbers
    ok, rows = checks.judge(numbers, ctx.limits)
    failed = sum(bool(kind.failed(u)) for u in rec.units)
    attempted = len(rec.units)

    err = []
    metrics = {}
    for m in (layer if rec.traced else e2e):
        value = readers[m["name"]].read(rec)
        if value is None:
            err.append(f"metric {m['name']}: nothing to read, left out")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        note = getattr(readers[m["name"]], "note", None)
        if note is not None and note(rec):
            err.append(f"metric {m['name']}: {note(rec)}")
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device) if cuda
                       else "cpu"),
              "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0 and attempted > 0),
              "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if rec.traced and rec.device is not None:
        device["busy_s"] = rec.device["busy_s"]
        device["window_s"] = rec.device["window_s"]
        result["breakdown"] = rec.device["breakdown"]
    elif rec.traced:
        err.append("the profiler's trace held no device operation: busy_s, "
                   "window_s and the device metrics not measured")
    if rec.reduce_s is not None:
        err.append(f"the profiled unit's trace reduced in {rec.reduce_s:.1f}"
                   " s")
    err.append(f"window: {attempted} units counted, {win.dropped} dropped "
               f"at the close, {win.steps} steps in {win.span_s} s; set-up "
               f"{rec.setup_s:.3f} s; units' seconds "
               f"{[round(u[1] - u[0], 3) for u in win.units]}; the output "
               f"check {rec.check_s:.1f} s")
    result["checks"] = checks.as_json(rows)
    err.extend(checks.lines(rows))
    return result, err


def main(argv=None):
    args = parse(argv)
    from benchmark.harness import manifest

    man = manifest.manifest()
    wl = manifest.workload(man, args.workload)
    environment(ROOT)
    import torch

    torch.set_num_threads(1)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(wl["chips"])):
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    ctx = make_ctx(man, args.workload, args.seed, device, bool(args.trace),
                   args.control)
    result, err = execute(ctx, man, args.seconds, T_START,
                          chips=int(wl["chips"]))
    return finish(result, err)


def finish(result, err):
    """Print the run's lines and result, unless the process holds JAX or
    the JAX package: then name what it holds and print no result."""
    from benchmark.harness import guard

    found = guard.forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures "
              "thinshelllab_torch alone; no result", file=sys.stderr)
        return 4
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


def _finite(obj):
    """The result with every float that is not finite written as null."""
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


if __name__ == "__main__":
    sys.exit(main())
