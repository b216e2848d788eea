"""Optimizers with the reference's semantics (counterpart of
`thinshelllab_tpu/optim/adam.py`; reference optimizer/optim.py).

Adam: bias-corrected Adam over the (T, n_part, 6) trajectory table, with
the reference's sqrt(v_hat + eps) denominator and the lr decayed by
`discount` every 10 steps (optim.py:37-81). State: float64 tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    it: torch.Tensor
    lr: torch.Tensor


class Adam:
    def __init__(self, shape, lr, beta_1=0.9, beta_2=0.9999, eps=1e-8,
                 discount=0.9, dtype=torch.float64, device="cpu"):
        self.shape = shape
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.eps = eps
        self.discount = discount
        self.lr0 = lr
        self.dtype = dtype
        self.device = torch.device(device)

    def init(self) -> AdamState:
        kw = dict(dtype=self.dtype, device=self.device)
        return AdamState(
            m=torch.zeros(self.shape, **kw),
            v=torch.zeros(self.shape, **kw),
            it=torch.zeros((), **kw),
            lr=torch.tensor(self.lr0, **kw),
        )

    def step(self, state: AdamState, params, grads):
        b1, b2 = self.beta_1, self.beta_2
        m = b1 * state.m + (1 - b1) * grads
        v = b2 * state.v + (1 - b2) * grads * grads
        it = state.it + 1.0
        m_hat = m / (1 - b1**it)
        v_hat = v / (1 - b2**it)
        # the reference divides by sqrt(v_hat + eps), not sqrt(v_hat) + eps
        new_params = params - state.lr * m_hat / torch.sqrt(v_hat + self.eps)
        lr = torch.where(torch.remainder(it, 10.0) == 0,
                         state.lr * self.discount, state.lr)
        return AdamState(m=m, v=v, it=it, lr=lr), new_params


class SGD:
    def __init__(self, lr):
        self.lr = lr

    def init(self):
        return ()

    def step(self, state, params, grads):
        return state, params - self.lr * grads
