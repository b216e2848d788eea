"""Gradient trajectory optimization driver (counterpart of
`thinshelllab_tpu/train/trajopt.py`; reference
training/trajopt_{folding,lifting,...}.py).

One iteration: rollout -> reward -> seed adjoint loss -> backward sweep ->
Adam step on the waypoint table -> motion-limit projection. The rollout
and the backward are the port's host loops (the JAX package jits them).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..agent.traj_opt import TrajAgent
from ..engine import adjoint, stepper
from ..optim.adam import Adam
from ..scenes.base import TaskScene, resolve_device
from ..utils.plotting import save_reward_curve


class TrajOptDriver:
    """device: where the scene runs (default the CUDA card; no card
    raises). fwd_chunk: the JAX package's rollout segments, kept for its
    API (stepper.simulate_chunked, which is simulate() in the port). With
    a save_dir, every iteration writes plot_data.npy and the reward curve
    plot.png, and a new best writes best_traj.npy."""

    def __init__(
        self,
        scene: TaskScene,
        tot_timestep: int,
        lr: float = 1e-3,
        max_dist: float = 0.015,
        vertical_only: bool = False,
        with_param_grad: bool = False,
        skip_steps: int = 0,
        accumulate_grad: bool = False,
        save_dir: Optional[str] = None,
        reward_name: str = "default",
        fwd_chunk: Optional[int] = None,
        device=None,
    ):
        self.fwd_chunk = fwd_chunk
        self.device = resolve_device(device, "TrajOptDriver")
        self.scene = scene
        self.reward_name = reward_name
        # objective variant: the matching seed when the scene defines one
        self._seed_loss = scene.seed_for(reward_name)
        self.T = tot_timestep
        self.agent = TrajAgent(tot_timestep, scene.n_part,
                               max_moving_dist=scene.max_moving_dist,
                               device=self.device)
        self.adam = Adam((tot_timestep, scene.n_part, 6), lr,
                         device=self.device)
        self.adam_state = self.adam.init()
        self.max_dist = max_dist
        self.save_dir = save_dir
        self.history = []
        self.best_reward = -np.inf
        self.vertical_only = vertical_only
        self.with_param_grad = with_param_grad
        self.skip_steps = skip_steps
        self.accumulate_grad = accumulate_grad
        self.spec, self.state0, self.params = scene.to(self.device)

    def forward(self, actions, stats=None):
        """The rollout from the scene's initial state: (final, buffers)."""
        if self.fwd_chunk:
            return stepper.simulate_chunked(self.spec, self.params,
                                            self.state0, actions,
                                            self.fwd_chunk, stats=stats)
        return stepper.simulate(self.spec, self.params, self.state0, actions,
                                stats=stats)

    def backward(self, buffers, seed_pos, seed_ar, **kw):
        return adjoint.backward(
            self.spec, self.params, buffers, seed_pos, seed_ar,
            vertical_only=self.vertical_only,
            with_param_grad=self.with_param_grad,
            skip_steps=self.skip_steps, **kw)

    def iteration(self, render_cb=None):
        """One optimization step. Returns reward, wall_time, grad_norm and
        param_grad as the JAX driver does, plus the backward's
        gripper_grad, the forward's solver `stats`, forward_s / backward_s
        (synchronized wall seconds) and the trajectory tape `buffers`."""
        t0 = time.time()
        stats = {}
        actions = self.agent.actions()
        _final, buffers = self.forward(actions, stats)
        reward = float(self.scene.reward(buffers, self.reward_name))
        t1 = time.time()

        seed_pos, seed_ar = self._seed_loss(buffers)
        res = self.backward(buffers, seed_pos, seed_ar)
        gg = res.gripper_grad
        if self.accumulate_grad:
            gg = gg.cpu().numpy().copy()
            for step in range(self.T - 2, 1, -1):
                for j in range(self.scene.n_part):
                    if (
                        self.agent.calculate_dist(step + 1, self.max_dist, j)
                        > self.agent.max_moving_dist - 5e-5
                    ):
                        gg[step, j] += gg[step + 1, j]
            gg = torch.as_tensor(gg, device=self.device)
        grad_norm = float(torch.linalg.vector_norm(res.gripper_grad))
        t2 = time.time()

        self.adam_state, new_traj = self.adam.step(
            self.adam_state, torch.as_tensor(self.agent.traj,
                                             device=self.device), gg)
        self.agent.traj = new_traj.cpu().numpy().copy()
        self.agent.fix_action(self.max_dist)

        self.history.append(reward)
        if reward > self.best_reward:
            self.best_reward = reward
            if self.save_dir:
                os.makedirs(self.save_dir, exist_ok=True)
                self.agent.save(os.path.join(self.save_dir, "best_traj.npy"))
        if self.save_dir:
            os.makedirs(self.save_dir, exist_ok=True)
            np.save(os.path.join(self.save_dir, "plot_data.npy"),
                    np.asarray(self.history))
            # reference parity: reward-curve PNG refreshed every iteration
            # (trajopt_folding.py:141-142)
            save_reward_curve(os.path.join(self.save_dir, "plot.png"),
                              self.history)
        if render_cb is not None:
            render_cb(buffers)
        return {
            "reward": reward,
            "wall_time": time.time() - t0,
            "grad_norm": grad_norm,
            "param_grad": res.param_grad,
            "gripper_grad": res.gripper_grad,
            "stats": stats,
            "forward_s": t1 - t0,
            "backward_s": t2 - t1,
            "buffers": buffers,
        }

    def run(self, iters: int, verbose=True):
        for i in range(iters):
            info = self.iteration()
            if verbose:
                print(
                    f"iter {i}: reward {info['reward']:.6f} "
                    f"|g| {info['grad_norm']:.4g} t {info['wall_time']:.2f}s"
                )
        return self.history
