"""The host CMA-ES strategy (counterpart of the `CMAES` class of
`thinshelllab_tpu/train/cmaes.py`): the standard (mu/mu_w, lambda)-CMA-ES
with rank-1 and rank-mu updates, in numpy with its own seeded generator,
so the port's ask/tell sequence is the JAX package's. The batched
population driver (`CMAESDriver`, `decode_genome`, `rollout_stop_step`)
is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np


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
