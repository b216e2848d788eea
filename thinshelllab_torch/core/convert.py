"""Carry a scene built by the JAX package into the port.

`from_reference(obj)` turns the JAX builder's `SceneSpec`, `SimState`
(the folding scene's plastic `ref_angle` included), `Params` (or any of
their nested dataclasses) into the port's dataclass of the same name:
numpy leaves are copied, static fields kept, the spec's dtype and SpMV
route renamed to the port's. `traj_agent_from_reference` and
`adam_state_from_reference` carry a trajectory optimisation's waypoint
table and optimizer state. It reads attributes only, so this module
imports no JAX; the tests use it to feed one scene to both packages.
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
