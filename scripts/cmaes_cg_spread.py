"""The run-to-run spread of chip_smoke's [cmaes-cg] generation on the card:
the same CMAESDriver generation (CMAES_CG_SCENE under solver="cg" in f32,
pop CMAES_POP, seed 0, Newton capped at CG_NEWTON) run N times in one
process, each with a fresh driver, so each run asks the same genomes. The
rollouts' scatter-adds sum with atomics in another order each run, so the
member rewards differ in their last digits. Prints each run's rewards,
then the largest relative spread of a member's reward over the runs
(max over members of (max - min) / |mean|), which chip_smoke's [mesh]
takes as its tolerance (MESH_CMAES_RTOL), and the card's name and power
limit.

Usage: PYTHONPATH=. python3 scripts/cmaes_cg_spread.py [N=3]
"""
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("cmaes_cg_spread.py needs a CUDA card")
    n = int(argv[0]) if argv else 3
    device = torch.device("cuda", 0)
    runs = []
    for i in range(n):
        _, secs, rewards = cs.cmaes_phase(device, cs.CMAES_CG_SCENE,
                                          solver="cg",
                                          max_newton_iter=cs.CG_NEWTON)
        runs.append(np.asarray(rewards))
        print(f"[spread] run {i}: {secs:.3f} s, rewards {rewards.tolist()}",
              flush=True)
    R = np.stack(runs)
    spread = (R.max(axis=0) - R.min(axis=0)) / np.abs(R.mean(axis=0))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"[spread] {n} runs of {cs.CMAES_CG_SCENE} under cg, pop "
          f"{cs.CMAES_POP}: relative spread per member {spread.tolist()}, "
          f"largest {float(spread.max()):.3e}; {smi}")


if __name__ == "__main__":
    main(sys.argv[1:])
