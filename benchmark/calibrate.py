"""Readings of a cell's output check over many seeds, in one process: the
lower readings (sound runs of the program) and the upper ones (the
control: the program one precision below the configuration's), from
which limits/<workload>.json is set. Not part of a benchmark run.

    python3 benchmark/calibrate.py --workload folding.trajopt \
        --seeds 11,12,13 --control-seeds 11,12,13 --seconds 0 \
        --out readings.jsonl

A trajopt cell compares its set-up iterations, so it needs no window
(--seconds 0). One JSON line a run."""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from benchmark import run
    from benchmark.harness import manifest

    run.environment(ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    man = manifest.manifest()
    device = torch.device("cuda", 0)
    jobs = [(int(s), False) for s in args.seeds.split(",") if s]
    jobs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed, control in jobs:
            ctx = run.make_ctx(man, args.workload, seed, device, False,
                               control)
            t0 = time.perf_counter()
            res, _err = run.execute(ctx, man, args.seconds, t0)
            line = json.dumps(run._finite({
                "workload": args.workload, "seed": seed, "control": control,
                "dtype": ctx.dtype, "attempted": res["attempted"],
                "wall_s": time.perf_counter() - t0,
                "setup_s": ctx.record.setup_s,
                "check_s": ctx.record.check_s,
                "checks": ctx.record.numbers,
            }))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
