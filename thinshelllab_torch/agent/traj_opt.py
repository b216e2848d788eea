"""Trajectory parametrization for gradient trajectory optimization
(counterpart of `thinshelllab_tpu/agent/traj_opt.py`; reference
agent/traj_opt_single.py).

The trajectory is a table of absolute waypoints traj[t, part, 6] (position
offset + rotation-vector offset), a host numpy float64 array: the motion
limit is a sequential projection over it. The per-step action is the
waypoint difference, projected so each step moves at most
max_moving_dist (position norm + max_dist * rotation norm).
"""
from __future__ import annotations

import numpy as np
import torch


class TrajAgent:
    def __init__(self, tot_timestep, n_part, max_moving_dist=0.0005,
                 device="cpu"):
        self.tot_timestep = tot_timestep
        self.n_part = n_part
        self.max_moving_dist = max_moving_dist
        self.device = torch.device(device)
        self.traj = np.zeros((tot_timestep, n_part, 6))

    # ------------------------------------------------------------- actions

    def actions(self):
        """Tuple of (T-1, n_part, 3)/(T-1, n_part, 3)/(T-1, n_part) float64
        action tensors on the agent's device for stepper.simulate (deltas
        of consecutive waypoints)."""
        delta = torch.as_tensor(self.traj[1:] - self.traj[:-1],
                                device=self.device)
        return (
            delta[:, :, 0:3],
            delta[:, :, 3:6],
            torch.zeros((self.tot_timestep - 1, self.n_part),
                        dtype=torch.float64, device=self.device),
        )

    def fix_action(self, max_dist):
        """Sequential per-step motion-limit projection (traj_opt_single.py
        :15-27): each projection changes the base of the next step."""
        for i in range(1, self.tot_timestep):
            for j in range(self.n_part):
                dist = self.calculate_dist(i, max_dist, j)
                weight = self.max_moving_dist / (dist + 1e-8)
                if weight < 1.0:
                    self.traj[i, j] = self.traj[i - 1, j] + (
                        self.traj[i, j] - self.traj[i - 1, j]
                    ) * weight

    def calculate_dist(self, frame, max_dist, j):
        dp = self.traj[frame, j, 0:3] - self.traj[frame - 1, j, 0:3]
        dr = self.traj[frame, j, 3:6] - self.traj[frame - 1, j, 3:6]
        return np.linalg.norm(dp) + np.linalg.norm(dr) * max_dist

    def apply_grad(self, update_fn):
        """traj <- update_fn(traj): the table goes in as a float64 tensor on
        the agent's device and comes back to the host."""
        new = update_fn(torch.as_tensor(self.traj, device=self.device))
        self.traj = new.detach().cpu().numpy().astype(np.float64, copy=True)

    # ----------------------------------------------------- warm starts
    # (reference traj_opt_single.py:50-109)

    def init_traj_forming(self):
        t = self.traj
        for i in range(1, 20):
            t[i, 0, 2] = -0.00011 * i
            t[i, 0, 0] = t[i - 1, 0, 0] + 0.00023
        for i in range(20, min(35, len(t))):
            t[i, 0, 2] = t[i - 1, 0, 2] - 0.0002
            t[i, 0, 0] = t[i - 1, 0, 0] + 0.00027
        for i in range(35, min(50, len(t))):
            t[i, 0, 2] = t[i - 1, 0, 2]
            t[i, 0, 0] = t[i - 1, 0, 0] + 0.0002

    def init_traj_pick_fold(self):
        t = self.traj
        for i in range(min(8, len(t))):
            t[i, 0, 2] = -0.0006 * i
            t[i, 1, 2] = -0.0006 * i
        for i in range(8, len(t)):
            t[i, :, :] = t[i - 1, :, :]

    def init_traj_card(self):
        t = self.traj
        n = len(t)
        for i in range(min(5, n)):
            t[i, 0, 0] = t[i - 1, 0, 0] + 0.0003
            t[i, 1, 0] = t[i - 1, 1, 0] - 0.0003
        for i in range(5, min(20, n)):
            t[i, 0, 0] = t[i - 1, 0, 0] + 0.0001
            t[i, 0, 2] = t[i - 1, 0, 2] + 0.0003
            t[i, 1, 0] = t[i - 1, 1, 0]
        for i in range(20, min(35, n)):
            t[i, 0, 0] = t[i - 1, 0, 0] + 0.0001
            t[i, 0, 2] = t[i - 1, 0, 2] + 0.0002
            t[i, 1, 0] = t[i - 1, 1, 0]
        for i in range(35, min(50, n)):
            t[i, 0, 0] = t[i - 1, 0, 0] + 0.0002
            t[i, 0, 2] = t[i - 1, 0, 2] + 0.0005
            t[i, 0, 4] = t[i - 1, 0, 4] + 0.02
            t[i, 1, 0] = t[i - 1, 1, 0]
        for i in range(50, n):
            t[i] = t[i - 1]

    def init_traj_slide(self):
        t = self.traj
        for i in range(min(10, len(t))):
            t[i, 0, 2] = -0.00035 * i
        for i in range(10, len(t)):
            t[i, 0, 0] = t[i - 1, 0, 0] - 0.0005
            t[i, 0, 2] = t[i - 1, 0, 2]

    def save(self, path):
        np.save(path, self.traj)

    def load(self, path):
        self.traj = np.load(path)
