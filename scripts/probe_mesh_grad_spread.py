"""How far the gripper gradient of chip_smoke's [mesh] (a) train step moves
between runs of the same code on the card: the full bench (BENCH_CFG) in
f32, MESH_B members of MESH_T steps pressing PRESS_Z a step (mesh_actions),
each member's forward and adjoint backward run `runs` times, from the
exact-grid cloth and from the cloth jittered by 1e-6 m (numpy seed 0, as
the CPU tests start the small bench), and from the grid once more under
torch's deterministic algorithms (chip_smoke.deterministic: the
scatter-adds then sum in one order). Prints, per start and run, each
step's max |gripper_grad| of the members' mean, the largest relative
difference to run 0 (max |d| / max |g|), the active contact slots of each
step, and every GMRES solve's (iterations, final relative residual), then
the card's name and power limit.

Usage: PYTHONPATH=. python3 scripts/probe_mesh_grad_spread.py [runs=3]
"""
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs


def one_run(sc, spec, s0, params, acts):
    from thinshelllab_torch.engine import adjoint, stepper

    grads, active = [], []
    for b in range(acts[0].shape[0]):
        _, buf = stepper.simulate(spec, params, s0,
                                  tuple(a[b] for a in acts),
                                  save_contacts=True)
        active.append(buf.pop("contact").active.sum(dim=1).tolist())
        # the backward rebuilds each step's contacts, as the train step's
        grads.append(adjoint.backward(spec, params, buf,
                                      *sc.seed_loss(buf)).gripper_grad)
    return torch.stack(grads).mean(dim=0), active


def main(argv):
    from thinshelllab_torch.scenes import bench_scene

    if not torch.cuda.is_available():
        raise SystemExit("probe_mesh_grad_spread.py needs a CUDA card")
    runs = int(argv[0]) if argv else 3
    device = torch.device("cuda", 0)
    sc = bench_scene.make(**cs.BENCH_CFG)
    spec, s0, params = sc.to(device, torch.float32)
    acts = cs.mesh_actions(sc.n_part, cs.MESH_B, spec.dtype, device)
    n_cloth = (cs.BENCH_CFG["cloth_N"] + 1) ** 2
    jitter = np.zeros(tuple(s0.pos.shape))
    jitter[:n_cloth] = 1e-6 * np.random.default_rng(0).normal(size=(n_cloth,
                                                                   3))
    jittered = s0.replace(pos=s0.pos + torch.as_tensor(
        jitter, dtype=s0.pos.dtype, device=device))
    for tag, start, det in (("grid", s0, False), ("jittered", jittered, False),
                            ("grid deterministic", s0, True)):
        first = None
        for r in range(runs):
            with cs.deterministic(det):
                (g, active), resid = cs.gmres_residuals(
                    lambda: one_run(sc, spec, start, params, acts))
            first = g if first is None else first
            per_step = g.abs().amax(dim=(1, 2)).tolist()
            print(f"[grad-spread] {tag} run {r}: max |g| per step "
                  f"{[f'{v:.4e}' for v in per_step]}; vs run 0 max rel err "
                  f"{cs.rel_err(g, first):.3e}; active slots per step "
                  f"{active}; GMRES {resid}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[grad-spread] {smi}")


if __name__ == "__main__":
    main(sys.argv[1:])
