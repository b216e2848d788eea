"""Differentiable-physics system-parameter identification, the "dp"
drivers (counterpart of `thinshelllab_tpu/train/dp.py`; reference
trajopt_bouncing.py / trajopt_card.py Kb loops, trajopt_silding.py's
friction-coefficient loop and the gradient-free run_cmaes_parameter.py).

Roll out a fixed trajectory, take the task loss back to one physical
parameter through the adjoint's parameter chain, and step it by clipped
gradient descent or by CMA-ES. The parameter is named as the scene's
`sys_param`: 'kb' (the first cloth's bending stiffness, `params.kb[0]`,
even on a scene with several cloths) or 'mu_pair:<i>' (friction slot i).
"""
from __future__ import annotations

import numpy as np
import torch

from ..engine import adjoint, stepper
from ..scenes.base import TaskScene, resolve_device
from .cmaes import CMAES


def _leaf(name):
    if name == "kb":
        return "kb", 0
    if name.startswith("mu_pair:"):
        return "mu_pairs", int(name.split(":")[1])
    raise KeyError(name)


def _get_param(params, name):
    field, i = _leaf(name)
    return getattr(params, field)[i]


def _set_param(params, name, value):
    field, i = _leaf(name)
    leaf = getattr(params, field).clone()
    leaf[i] = value
    return params.replace(**{field: leaf})


def _param_grad(pgrad, name):
    return float(_get_param(pgrad, name))


class _ParamDriver:
    """The scene and the fixed trajectory on `device` (default the CUDA
    card; no card raises)."""

    def __init__(self, scene: TaskScene, actions, param, device, caller):
        self.device = resolve_device(device, caller)
        self.scene = scene
        self.param = param or scene.sys_param
        assert self.param is not None
        self.spec, self.state0, self.params = scene.to(self.device)
        self.actions = tuple(
            torch.as_tensor(a, dtype=self.spec.dtype, device=self.device)
            for a in actions)

    def _simulate(self, params):
        return stepper.simulate(self.spec, params, self.state0,
                                self.actions)[1]


class ParamOptDriver(_ParamDriver):
    """Gradient descent on one physical parameter with a fixed trajectory."""

    def __init__(self, scene: TaskScene, actions, lr=1.0, param=None,
                 grad_clip=1.0, device=None):
        super().__init__(scene, actions, param, device, "ParamOptDriver")
        self.lr = lr
        self.grad_clip = grad_clip
        self.history = []

    def _run(self, params):
        buffers = self._simulate(params)
        reward = self.scene.reward(buffers)
        res = adjoint.backward(self.spec, params, buffers,
                               *self.scene.seed_loss(buffers),
                               with_param_grad=True)
        return reward, res.param_grad

    def iteration(self):
        reward, pgrad = self._run(self.params)
        # reference clamps the parameter gradient to +-1
        # (analytic_grad_system setup + trajopt_card.py:108)
        g = float(np.clip(_param_grad(pgrad, self.param), -self.grad_clip,
                          self.grad_clip))
        value = float(_get_param(self.params, self.param)) - self.lr * g
        value = max(value, 1e-4)  # reference run_cmaes_parameter.py:94,97
        self.params = _set_param(self.params, self.param, value)
        self.history.append((float(reward), value, g))
        return {"reward": float(reward), "param": value, "grad": g}


class ParamCMAESDriver(_ParamDriver):
    """Gradient-free parameter identification (run_cmaes_parameter.py):
    CMA-ES over one scalar physical parameter with a fixed trajectory; the
    population is evaluated one rollout after another."""

    def __init__(self, scene: TaskScene, actions, base_value, scale=1.0,
                 param=None, pop_size=8, sigma=1.0, seed=0, device=None):
        super().__init__(scene, actions, param, device, "ParamCMAESDriver")
        self.base = base_value
        self.scale = scale
        self.es = CMAES(np.zeros(1), sigma, popsize=pop_size, seed=seed)

    def generation(self):
        X = self.es.ask()
        fits = []
        for x in X:
            v = max(1e-4, self.base + float(x[0]) * self.scale)
            params = _set_param(self.params, self.param, v)
            fits.append(-float(self.scene.reward(self._simulate(params))))
        self.es.tell(X, fits)
        best_v = max(1e-4, self.base + float(self.es.best_x[0]) * self.scale)
        return {"best_param": best_v, "best_reward": -self.es.best_f}
