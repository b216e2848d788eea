"""Carry a scene built by the JAX package into the port.

`from_reference(obj)` turns the JAX builder's `SceneSpec`, `SimState`
(the folding scene's plastic `ref_angle` included), `Params` (or any of
their nested dataclasses) into the port's dataclass of the same name:
numpy leaves are copied, static fields kept, the spec's dtype and SpMV
route renamed to the port's. `traj_agent_from_reference` and
`adam_state_from_reference` carry a trajectory optimisation's waypoint
table and optimizer state, `cmaes_from_reference` a CMA-ES strategy,
`cmaes_driver_from_reference` a whole CMA-ES driver, and
`ppo_from_reference`, `sac_from_reference` and `rppo_from_reference` an
RL trainer's parameters with optax's Adam moments and count.
`tape_from_entries` rebuilds a JAX tape kept flat in a golden file, and
`golden_grad_errors` measures an adjoint's gradients against the ones kept
beside it. It reads attributes only, so this module imports no JAX; the
tests and chip_smoke.py use it to feed one scene to both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spec as _spec

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}
_SPMV = {"auto": "auto", "pallas": "kernel", "xla": "plain"}


def torch_dtype(d) -> torch.dtype:
    """torch dtype of a numpy/JAX float dtype or scalar type."""
    if isinstance(d, torch.dtype):
        return d
    return _DTYPES[np.dtype(d)]


def _tensor(v):
    """CPU tensor of an array leaf: floats and bools keep their type,
    integers become int64 (the port's index type, as SceneSpec.to makes
    them)."""
    t = torch.as_tensor(np.array(v, copy=True))
    if t.dtype.is_floating_point or t.dtype == torch.bool:
        return t
    return t.to(torch.int64)


def buffers_from_reference(buffers):
    """The port's trajectory tape from the JAX `stepper.simulate` buffers
    dict: every array leaf a CPU tensor, and the stacked ContactSet under
    "contact" (save_contacts=True) the port's ContactSet. With it both
    adjoints run on one tape."""
    out = {}
    for key, v in buffers.items():
        if dataclasses.is_dataclass(v):
            cls = getattr(_spec, type(v).__name__)
            v = cls(**{f.name: _tensor(getattr(v, f.name))
                       for f in dataclasses.fields(v)})
        else:
            v = _tensor(v)
        out[key] = v
    return out


def tape_from_entries(entries, device="cpu"):
    """The port's tape, on `device`, from the flat numpy entries a golden
    file keeps the JAX package's `simulate(save_contacts=True)` buffers
    in: "tape.<key>" and, for the stacked ContactSet, "tape.contact.<field>"
    (float leaves keep their dtype)."""
    pre, cpre = "tape.", "tape.contact."
    tape = {k[len(pre):]: v for k, v in entries.items()
            if k.startswith(pre) and not k.startswith(cpre)}
    tape["contact"] = _spec.ContactSet(**{
        k[len(cpre):]: v for k, v in entries.items() if k.startswith(cpre)})
    out = buffers_from_reference(tape)
    c = out["contact"]
    out["contact"] = c.to(device, c.w.dtype)
    return {k: v if k == "contact" else v.to(device) for k, v in out.items()}


def golden_grad_errors(res, entries, sys_param):
    """An AdjointResult's gradients against the golden entries
    "gripper_grad" and "param_grad.<leaf>": (gripper_grad, every Params
    leaf, the system-ID parameter's own entry), the first two as a fraction
    of the largest golden entry they compare, the last of itself. The
    parameter errors are 0 where the golden has none."""
    from ..train import dp

    def arr(t):
        return t.detach().cpu().numpy()

    want = np.asarray(entries["gripper_grad"])
    got = arr(res.gripper_grad)
    if got.shape != want.shape:
        raise ValueError(f"gripper_grad {got.shape} against {want.shape}")
    scale = np.abs(want).max()
    gg = float(np.abs(got - want).max() / (scale if scale > 0 else 1.0))
    keys = [k for k in entries if k.startswith("param_grad.")]
    if not keys:
        return gg, 0.0, 0.0
    scale = max(np.abs(entries[k]).max() for k in keys)
    pg = max(float(np.abs(arr(getattr(res.param_grad, k.split(".", 1)[1]))
                          - entries[k]).max()) for k in keys) / scale
    field, i = dp._leaf(sys_param)
    want = float(entries["param_grad." + field][i])
    got = float(getattr(res.param_grad, field)[i])
    return gg, pg, abs(got - want) / abs(want)


def from_reference(obj):
    """The port's counterpart of a JAX-side spec/state/params object."""
    if obj is None or isinstance(obj, (tuple, list, int, float, str, bool)):
        return obj
    if isinstance(obj, np.ndarray):
        return np.array(obj, copy=True)
    if not dataclasses.is_dataclass(obj):
        return np.array(obj, copy=True)  # a device array of the reference
    cls = getattr(_spec, type(obj).__name__)
    kw = {}
    names = {f.name for f in dataclasses.fields(cls)}
    for f in dataclasses.fields(obj):
        if f.name not in names:
            raise TypeError(f"{cls.__name__} has no field {f.name!r}")
        v = getattr(obj, f.name)
        if f.name == "dtype":
            v = torch_dtype(v)
        elif f.name == "spmv":
            v = _SPMV[v]
        else:
            v = from_reference(v)
        kw[f.name] = v
    return cls(**kw)


def traj_agent_from_reference(agent, device="cpu"):
    """The port's TrajAgent with a JAX `TrajAgent`'s sizes, motion limit
    and waypoint table (copied, float64)."""
    from ..agent.traj_opt import TrajAgent

    out = TrajAgent(agent.tot_timestep, agent.n_part,
                    max_moving_dist=agent.max_moving_dist, device=device)
    out.traj = np.array(agent.traj, dtype=np.float64, copy=True)
    return out


def adam_state_from_reference(state, device="cpu"):
    """The port's AdamState (float64 tensors on `device`) of a JAX
    `AdamState`."""
    from ..optim.adam import AdamState

    return AdamState(*(torch.as_tensor(np.array(v, dtype=np.float64),
                                       device=device) for v in state))


def cmaes_from_reference(es):
    """The port's host CMAES with a JAX `CMAES`'s whole state: its sizes
    and weights, the evolution paths, the covariance and its eigensystem,
    the generation count, the best point, and its generator's state, so
    the next ask/tell continue the JAX sequence."""
    from ..train.cmaes import CMAES

    out = CMAES.__new__(CMAES)
    for key, v in vars(es).items():
        out.__dict__[key] = v.copy() if isinstance(v, np.ndarray) else v
    out.rng = np.random.default_rng()
    out.rng.bit_generator.state = es.rng.bit_generator.state
    return out


def cmaes_driver_from_reference(drv, scene, device="cpu", mesh=None):
    """The port's CMAESDriver on the port's `scene` (its rewards are the
    port's own) with a JAX `CMAESDriver`'s settings, whole strategy state
    (cmaes_from_reference) and reward history. A JAX driver that held a
    device mesh is carried onto the port's `mesh` (a parallel.mesh.Mesh),
    whose device it then takes."""
    from ..train.cmaes import CMAESDriver

    out = CMAESDriver(scene, drv.tot_timestep, drv.abs_step,
                      pop_size=drv.pop_size, sigma=drv.sigma,
                      reward_name=drv.reward_name, max_dist=drv.max_dist,
                      seed=drv.seed, skip_first=drv.skip_first, mesh=mesh,
                      device=device if mesh is None else mesh.device)
    out.es = cmaes_from_reference(drv.es)
    out.history = list(drv.history)
    return out


def _adam_moments(opt_state):
    """(count, mu, nu) of an optax.adam state: the ScaleByAdamState in
    its chain."""
    for s in opt_state:
        if hasattr(s, "mu") and hasattr(s, "nu"):
            return int(np.asarray(s.count)), s.mu, s.nu
    raise TypeError("no Adam moments in this optimizer state")


def _mlp_leaves(mlp, layers):
    """(parameter, array in the parameter's layout) of each Linear of a
    port MLP against the JAX [(W (in, out), b), ...] tree."""
    out = []
    for lin, (w, b) in zip(mlp.layers, layers, strict=True):
        out += [(lin.weight, np.asarray(w).T), (lin.bias, np.asarray(b))]
    return out


def _lstm_leaves(lstm, arrays):
    wi, wh, b = (np.asarray(a) for a in arrays)
    return [(lstm.wi, wi.T), (lstm.wh, wh.T), (lstm.b, b)]


def _load_params(leaves):
    with torch.no_grad():
        for p, a in leaves:
            p.copy_(torch.tensor(np.asarray(a), dtype=p.dtype))


def _load_adam(optimizer, params, mu_leaves, nu_leaves, count):
    """torch.optim.Adam state of `params` from optax's moments (each
    already in its parameter's layout) and step count."""
    for p, (_, m), (_, v) in zip(params, mu_leaves, nu_leaves, strict=True):
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(m), dtype=p.dtype,
                                    device=p.device),
            "exp_avg_sq": torch.tensor(np.asarray(v), dtype=p.dtype,
                                       device=p.device),
        }


def _carry(optimizer, leaves_fn, params_tree, opt_state):
    """Load a parameter tree and its optax Adam state into the port."""
    leaves = leaves_fn(params_tree)
    _load_params(leaves)
    count, mu, nu = _adam_moments(opt_state)
    _load_adam(optimizer, [p for p, _ in leaves], leaves_fn(mu),
               leaves_fn(nu), count)


def ppo_from_reference(state, trainer):
    """Load a JAX `PPOState` (pi, vf, log_std and optax.adam's state) into
    a port PPOTrainer of the same sizes; returns the trainer."""
    def leaves(tree):
        pi, vf, log_std = tree
        return (_mlp_leaves(trainer.pi, pi) + _mlp_leaves(trainer.vf, vf)
                + [(trainer.log_std, np.asarray(log_std))])

    _carry(trainer.optimizer, leaves, (state.pi, state.vf, state.log_std),
           state.opt_state)
    return trainer


def sac_from_reference(state, trainer):
    """Load a JAX `SACState` (actor, twin critics, their targets, the
    temperature and the three optax.adam states) into a port SACTrainer
    of the same sizes; returns the trainer."""
    _carry(trainer.actor_opt, lambda a: _mlp_leaves(trainer.actor, a),
           state.actor, state.actor_opt)
    _carry(trainer.q_opt, lambda q: (_mlp_leaves(trainer.q1, q[0])
                                     + _mlp_leaves(trainer.q2, q[1])),
           (state.q1, state.q2), state.q_opt)
    _carry(trainer.alpha_opt,
           lambda a: [(trainer.log_alpha, np.asarray(a))],
           state.log_alpha, state.alpha_opt)
    _load_params(_mlp_leaves(trainer.q1_targ, state.q1_targ)
                 + _mlp_leaves(trainer.q2_targ, state.q2_targ))
    return trainer


def rppo_from_reference(state, trainer):
    """Load a JAX `RPPOState` (LSTM, pi, vf, log_std and optax.adam's
    state) into a port RecurrentPPOTrainer of the same sizes; returns the
    trainer."""
    def leaves(tree):
        lstm, pi, vf, log_std = tree
        return (_lstm_leaves(trainer.lstm, lstm)
                + _mlp_leaves(trainer.pi, pi) + _mlp_leaves(trainer.vf, vf)
                + [(trainer.log_std, np.asarray(log_std))])

    _carry(trainer.optimizer, leaves,
           (state.lstm, state.pi, state.vf, state.log_std), state.opt_state)
    return trainer
