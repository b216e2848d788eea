"""Per-Newton-iteration times of the element layer and the dense solve in
the benchmark cell folding.trajopt_jitter, each program function wrapped
in ONE span.

The benchmark's traced run wraps ops/spd.project_psd once for each metric
that names it (element_ms_per_newton and dense_solve_ms_per_newton), so
every projection's time lands twice in the nested spans, and
element_ms_per_newton (all_groups less project_psd) can come out at or
below zero and be left out of the result line. This probe builds the
cell's scene, jitter and warm-start waypoints with the benchmark's own
helpers (benchmark/configs/folding-f64.json, benchmark/traffic/
trajopt_jitter.json), runs the cell's two warm-up iterations, then
`--iters` TrajOptDriver iterations with the benchmark's span class around
the driver's forward and backward and around elements.all_groups,
spd.project_psd and solver.solve_dense, once each, and prints the
readers' arithmetic on those spans:

  element_ms_per_newton      all_groups less the project_psd nested in it
  dense_solve_ms_per_newton  solve_dense plus project_psd
  fwd_ms_per_step, bwd_ms_per_step, newton_per_step

Run from the root of a checkout on a card (another checkout, such as a
parent unpacked into _parent/, takes the same script from its own root):

    PYTHONPATH=. python3 scripts/probe_element_spans.py --seed 3100000003
    cd _parent && PYTHONPATH=. python3 ../scripts/probe_element_spans.py
"""
import argparse
import importlib
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

from benchmark.harness import inputs, program  # noqa: E402
from benchmark.harness.spans import Spans, seconds  # noqa: E402

CELL_CONFIG = "benchmark/configs/folding-f64.json"
CELL_TRAFFIC = "benchmark/traffic/trajopt_jitter.json"
TARGETS = (("thinshelllab_torch.engine.elements", "all_groups"),
           ("thinshelllab_torch.ops.spd", "project_psd"),
           ("thinshelllab_torch.engine.solver", "solve_dense"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()

    from thinshelllab_torch.train.trajopt import TrajOptDriver

    with open(CELL_CONFIG) as f:
        cfg = json.load(f)
    with open(CELL_TRAFFIC) as f:
        tr = json.load(f)
    device = torch.device(a.device)
    T = int(cfg["tot_step"])
    sc = inputs.jitter(program.make_scene(cfg, cfg["dtype"]), a.seed,
                       tr["cloth_jitter_m"])
    drv = TrajOptDriver(sc, T, lr=tr["lr"], max_dist=tr["max_dist"],
                        device=device)
    drv.agent.traj = inputs.waypoints(a.seed, T, sc.n_part,
                                      tr["dz_per_step"],
                                      tr["waypoint_sigma_m"])
    for _ in range(int(tr["compare_iterations"])):
        drv.iteration()

    sp = Spans()
    sp.wrap(drv, "forward", "forward")
    sp.wrap(drv, "backward", "backward")
    for mod, attr in TARGETS:
        sp.wrap(importlib.import_module(mod), attr, attr)
    newton = 0
    try:
        for _ in range(a.iters):
            info = drv.iteration()
            newton += sum(info["stats"]["newton_per_step"])
    finally:
        sp.restore()
    spans = {p: (sp.total[p], sp.count[p]) for p in sp.total}
    steps = a.iters * (T - 1)

    def ms(label, within="forward"):
        return 1e3 * seconds(spans, label, within)

    out = {
        "seed": a.seed, "iterations": a.iters, "steps": steps,
        "newton_per_step": newton / steps,
        "element_ms_per_newton":
            (ms("all_groups") - ms("project_psd", "all_groups")) / newton,
        "dense_solve_ms_per_newton":
            (ms("solve_dense") + ms("project_psd")) / newton,
        "all_groups_ms_per_newton": ms("all_groups") / newton,
        "project_psd_ms_per_newton": ms("project_psd") / newton,
        "fwd_ms_per_step": ms("forward", None) / steps,
        "bwd_ms_per_step": ms("backward", None) / steps,
        "spans": {p: [round(s, 6), n] for p, (s, n) in sorted(spans.items())},
    }
    print("SPANS " + json.dumps(out))


if __name__ == "__main__":
    main()
