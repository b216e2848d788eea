"""Times a `cli cmaes` or `cli rl` run of thinshelllab_torch on the card:
the CLI runs as given, with synchronized wall clocks around every
CMA-ES generation, every BatchedEnv step (N environments, one after
another) and every trainer update (one Adam step of the policy). Prints
one `[time-cli]` line: the card's name and power limit, then the count and
the mean seconds of each.

Usage: PYTHONPATH=. python3 scripts/time_policy_search.py cmaes --env
folding --pop_size 4 --iter 1 --tot_step 2 --abs_step 2
       PYTHONPATH=. python3 scripts/time_policy_search.py rl --env folding
--algo ppo --n_envs 2 --horizon 2 --timesteps 4 --tot_step 3
"""
import subprocess
import sys
import time

import torch

from thinshelllab_torch import cli
from thinshelllab_torch.train import cmaes, ppo, recurrent_ppo, rl_env, sac

TIMES = {}


def timed(cls, name, key):
    fn = getattr(cls, name)

    def wrapped(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        TIMES.setdefault(key, []).append(time.perf_counter() - t0)
        return out

    setattr(cls, name, wrapped)


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("time_policy_search.py: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    timed(cmaes.CMAESDriver, "generation", "generation")
    timed(rl_env.BatchedEnv, "step", "env step")
    for cls in (ppo.PPOTrainer, sac.SACTrainer,
                recurrent_ppo.RecurrentPPOTrainer):
        timed(cls, "update", "update")
    t0 = time.perf_counter()
    cli.main(argv)
    wall = time.perf_counter() - t0
    parts = [f"{k}: {len(v)} x {sum(v) / len(v):.4f} s"
             for k, v in TIMES.items()]
    print(f"[time-cli] {smi}; cli {' '.join(argv)}: {wall:.2f} s in all; "
          f"{'; '.join(parts)}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
