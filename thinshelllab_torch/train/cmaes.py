"""CMA-ES policy search (counterpart of `thinshelllab_tpu/train/cmaes.py`;
reference training/run_cmaes_all.py).

`CMAES` is the host strategy: the standard (mu/mu_w, lambda)-CMA-ES with
rank-1 and rank-mu updates, in numpy with its own seeded generator, so the
port's ask/tell sequence is the JAX package's. `CMAESDriver` evaluates
each generation's population one member after another, each a
`stepper.simulate` on the driver's device; the JAX package vmaps the
population into one program instead (a batched population is perf work,
ROADMAP.md). With a mesh (`parallel.mesh.make_mesh`) each rank evaluates
its block of the population and the results are all-gathered in member
order, as the JAX driver's shard_map does.

Genome encoding matches the reference (:88-114): abs_step x 6 x n_part
deltas in [0,10] around 5, scaled by scaling = 5/(sub_steps*3e-4) for
positions and 5/(sub_steps*1e-2) for rotations, integrated into absolute
waypoints and motion-limited by fix_action(0.015).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..agent.traj_opt import TrajAgent
from ..core.spec import GripperState, SimState
from ..engine import stepper
from ..parallel.mesh import Mesh, all_gather_blocks, block
from ..scenes.base import TaskScene, effector_total_forces, resolve_device


class CMAES:
    """Minimal, dependency-free CMA-ES (Hansen's standard parameterization)."""

    def __init__(self, x0, sigma0, popsize=None, seed=0):
        self.dim = len(x0)
        self.mean = np.asarray(x0, np.float64)
        self.sigma = float(sigma0)
        self.lam = popsize or 4 + int(3 * np.log(self.dim))
        self.mu = self.lam // 2
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        self.weights = w / w.sum()
        self.mueff = 1.0 / np.sum(self.weights**2)
        n = self.dim
        self.cc = (4 + self.mueff / n) / (n + 4 + 2 * self.mueff / n)
        self.cs = (self.mueff + 2) / (n + self.mueff + 5)
        self.c1 = 2 / ((n + 1.3) ** 2 + self.mueff)
        self.cmu = min(
            1 - self.c1,
            2 * (self.mueff - 2 + 1 / self.mueff)
            / ((n + 2) ** 2 + self.mueff),
        )
        self.damps = (1 + 2 * max(0, np.sqrt((self.mueff - 1) / (n + 1)) - 1)
                      + self.cs)
        self.pc = np.zeros(n)
        self.ps = np.zeros(n)
        self.C = np.eye(n)
        self.B = np.eye(n)
        self.D = np.ones(n)
        self.chiN = np.sqrt(n) * (1 - 1 / (4 * n) + 1 / (21 * n * n))
        self.rng = np.random.default_rng(seed)
        self.gen = 0
        self.best_x = self.mean.copy()
        self.best_f = np.inf

    def ask(self):
        z = self.rng.standard_normal((self.lam, self.dim))
        y = z @ (self.B * self.D).T
        return self.mean[None, :] + self.sigma * y

    def tell(self, X, fitness):
        """fitness: to MINIMIZE (reference convention: negative reward)."""
        fitness = np.asarray(fitness)
        order = np.argsort(fitness)
        if fitness[order[0]] < self.best_f:
            self.best_f = fitness[order[0]]
            self.best_x = X[order[0]].copy()
        sel = X[order[: self.mu]]
        y = (sel - self.mean[None, :]) / self.sigma
        y_w = self.weights @ y
        self.mean = self.mean + self.sigma * y_w

        C_inv_sqrt = self.B @ np.diag(1.0 / self.D) @ self.B.T
        self.ps = (1 - self.cs) * self.ps + np.sqrt(
            self.cs * (2 - self.cs) * self.mueff
        ) * (C_inv_sqrt @ y_w)
        hsig = np.linalg.norm(self.ps) / np.sqrt(
            1 - (1 - self.cs) ** (2 * (self.gen + 1))
        ) / self.chiN < 1.4 + 2 / (self.dim + 1)
        self.pc = (1 - self.cc) * self.pc + hsig * np.sqrt(
            self.cc * (2 - self.cc) * self.mueff
        ) * y_w
        artmp = y
        self.C = (
            (1 - self.c1 - self.cmu) * self.C
            + self.c1
            * (
                np.outer(self.pc, self.pc)
                + (not hsig) * self.cc * (2 - self.cc) * self.C
            )
            + self.cmu * (artmp.T * self.weights) @ artmp
        )
        self.sigma = self.sigma * np.exp(
            (self.cs / self.damps) * (np.linalg.norm(self.ps) / self.chiN - 1)
        )
        self.gen += 1
        if self.gen % max(1, self.dim // 10) == 0:
            self.C = np.triu(self.C) + np.triu(self.C, 1).T
            d, B = np.linalg.eigh(self.C)
            self.D = np.sqrt(np.maximum(d, 1e-20))
            self.B = B

    @property
    def result(self):
        return type("R", (), {"xbest": self.best_x, "fbest": self.best_f})


def decode_genome(x, tot_timestep, abs_step, n_part, max_dist=0.015,
                  skip_first=0, device="cpu"):
    """Genome -> motion-limited waypoint table (reference :98-114); the
    agent's actions() land on `device`."""
    agent = TrajAgent(tot_timestep, n_part, device=device)
    sub_steps = int(tot_timestep / abs_step)
    scaling = 5.0 / (sub_steps * 0.0003)
    scaling_angle = 5.0 / (sub_steps * 0.01)
    g = np.asarray(x).reshape(abs_step, n_part, 6)
    for ii in range(abs_step):
        for jj in range(sub_steps):
            if ii == 0 and jj == 0:
                continue
            i = ii * sub_steps + jj
            if i >= tot_timestep:
                break
            if i < skip_first:
                agent.traj[i] = agent.traj[i - 1]
                continue
            agent.traj[i, :, 0:3] = (
                agent.traj[i - 1, :, 0:3]
                + (g[ii, :, 0:3] - 5) / sub_steps / scaling
            )
            agent.traj[i, :, 3:6] = (
                agent.traj[i - 1, :, 3:6]
                + (g[ii, :, 3:6] - 5) / sub_steps / scaling_angle
            )
    agent.fix_action(max_dist)
    return agent


def tape_state(buffers, t):
    """The SimState at tape index t as the early-stop test reads it: the
    tape's positions, rest angles and gripper, zero velocity and the
    rollout's final projection latch (the test reads neither)."""
    return SimState(
        pos=buffers["pos"][t], vel=torch.zeros_like(buffers["pos"][t]),
        ref_angle=buffers["ref_angle"][t],
        proj_flag=buffers["final_proj_flag"],
        proj_dir=buffers["final_proj_dir"],
        gripper=GripperState(
            pos=buffers["gripper_pos"][t], rot=buffers["gripper_rot"][t],
            dist=buffers["gripper_dist"][t],
            pad_local=buffers["pad_local"][t]),
    )


def rollout_stop_step(spec, params, buffers):
    """Early-stop accounting over a completed rollout tape: the first step
    whose state the reference would abort on (run_cmaes_all.py:124-161 via
    BaseScene.check_early_stop:1559-1584 -- any effector force component
    > 10 N, NaN positions, or contact lost after frame 10).

    check_early_stop's inputs depend only on the positions and the gripper
    pose at step t, both on the tape, so testing every tape step after the
    rollout finds the first step a live per-step test would stop at, and
    the cumsum latch gives 'no later step runs' for the reward.

    Returns (stop_step, early) as a Python int and bool."""
    T = buffers["pos"].shape[0]
    if spec.gripper.n_part == 0:
        return T, False
    forces = torch.stack([
        effector_total_forces(spec, params, tape_state(buffers, t))
        for t in range(T)])  # (T, n_part, 3)
    pos = buffers["pos"]
    bad = torch.any(torch.abs(forces) > 10.0, dim=(1, 2))
    bad = bad | torch.any(torch.isnan(pos), dim=(1, 2))
    frames = torch.arange(T, device=pos.device)
    no_contact = (torch.any(torch.linalg.vector_norm(forces, dim=2) < 0.2,
                            dim=1) & (frames > 10))
    bad = bad | no_contact
    stopped = torch.cumsum(bad.to(torch.int32), dim=0) > 0
    return int(torch.sum(~stopped)), bool(torch.any(bad))


@dataclasses.dataclass
class CMAESDriver:
    """CMA-ES over a task scene's waypoint genome. Each generation asks the
    strategy for pop_size genomes, decodes each into a waypoint table and
    rolls it out on `device` (default the CUDA card; no card raises), one
    member after another. A member's reward is
    stop_step / T * 0.1 + (0 if it stopped early else task reward + 5).

    `max_dist` is kept as the JAX driver keeps it: the JAX driver decodes
    every genome with decode_genome's own limit of 0.015 and never reads
    the field, and so does this one (ROADMAP.md §3).

    `mesh` (a `parallel.mesh.Mesh`) shards the population over its ranks:
    every rank holds the same strategy, so it asks the same genomes,
    evaluates its contiguous block of members on the mesh's device, and
    all-gathers the rewards, stop steps and early flags in member order;
    every rank then makes the same tell and the ranks stay in lockstep.
    The population must split evenly over the mesh."""

    scene: TaskScene
    tot_timestep: int
    abs_step: int
    pop_size: int = 8
    sigma: float = 1.0
    reward_name: str = "default"
    max_dist: float = 0.002
    seed: int = 0
    skip_first: int = 0
    mesh: object = None
    device: object = None

    def __post_init__(self):
        if self.mesh is not None:
            if not isinstance(self.mesh, Mesh):
                raise TypeError(f"CMAESDriver(mesh=...): a parallel.mesh."
                                f"Mesh, not {type(self.mesh).__name__}")
            if (self.device is not None
                    and torch.device(self.device) != self.mesh.device):
                raise ValueError(f"CMAESDriver: device {self.device} is not "
                                 f"the mesh's {self.mesh.device}")
            self.device = self.mesh.device
        self.device = resolve_device(self.device, "CMAESDriver")
        n_part = self.scene.n_part
        self.es = CMAES(np.full(self.abs_step * 6 * n_part, 5.0), self.sigma,
                        popsize=self.pop_size, seed=self.seed)
        if self.mesh is not None:
            block(self.mesh, self.es.lam)  # the population must split evenly
        self.spec, self.state0, self.params = self.scene.to(self.device)
        self.reward_fn = self.scene.rewards[self.reward_name]
        self.history = []

    def _decode(self, x):
        return decode_genome(x, self.tot_timestep, self.abs_step,
                             self.scene.n_part, skip_first=self.skip_first,
                             device=self.device)

    def evaluate(self, actions):
        """One member's rollout: (reward, stop_step, early)."""
        _final, buffers = stepper.simulate(self.spec, self.params,
                                           self.state0, actions)
        task_reward = float(self.reward_fn(buffers))
        stop_step, early = rollout_stop_step(self.spec, self.params, buffers)
        reward = stop_step / self.tot_timestep * 0.1
        return reward + (0.0 if early else task_reward + 5.0), stop_step, early

    def generation(self):
        """Ask, evaluate every member, tell. Returns the best reward so far,
        this generation's best and mean, and each member's reward, stop
        step and early flag."""
        X = self.es.ask()
        lo, hi = (0, len(X)) if self.mesh is None else block(self.mesh,
                                                              len(X))
        runs = [self.evaluate(self._decode(x).actions()) for x in X[lo:hi]]
        if self.mesh is not None:
            # (reward, stop step, early) rows of every rank, member order;
            # the stop steps and flags are small integers, exact in float64
            rows = all_gather_blocks(self.mesh, torch.tensor(
                runs, dtype=torch.float64).reshape(-1, 3))
            runs = [(float(r), int(s), bool(e))
                    for r, s, e in rows.cpu().tolist()]
        rewards = np.array([r[0] for r in runs])
        self.es.tell(X, -rewards)
        self.history.extend((-rewards).tolist())
        return {
            "best_reward": -self.es.best_f,
            "gen_best": float(rewards.max()),
            "gen_mean": float(rewards.mean()),
            "rewards": rewards,
            "stop_steps": [r[1] for r in runs],
            "early": [r[2] for r in runs],
        }

    def best_agent(self):
        return self._decode(self.es.result.xbest)
