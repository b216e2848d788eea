"""Simulation-state checkpoints (counterpart of
`thinshelllab_tpu/utils/checkpoint.py`; reference BaseScene.save_state /
load_state and Scene_balancing.save_all / load_all:202-222).

One npz holds the full SimState: positions, velocities, plastic rest
angles, the latched projection state and the gripper bundle. The keys are
the JAX package's, so a state saved by either package loads in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.spec import GripperState, SimState
from ..scenes.base import resolve_device


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def save_state(state: SimState, path: str):
    g = state.gripper
    np.savez(
        path,
        pos=_host(state.pos),
        vel=_host(state.vel),
        ref_angle=_host(state.ref_angle),
        proj_flag=_host(state.proj_flag).astype(np.int32),
        proj_dir=_host(state.proj_dir).astype(np.int32),
        g_pos=_host(g.pos),
        g_rot=_host(g.rot),
        g_dist=_host(g.dist),
        g_pad_local=_host(g.pad_local),
    )


def load_state(path: str, dtype=torch.float64, device=None) -> SimState:
    """The SimState of an npz, as tensors on `device` (default the CUDA
    card; no card raises, the CPU is taken only when asked for): float
    leaves in `dtype` (pass the scene's), the projection state int32."""
    device = resolve_device(device, "load_state")
    z = np.load(path)

    def f(key):
        return torch.as_tensor(z[key], dtype=dtype, device=device)

    def i(key):
        return torch.as_tensor(z[key].astype(np.int32), device=device)

    return SimState(
        pos=f("pos"), vel=f("vel"), ref_angle=f("ref_angle"),
        proj_flag=i("proj_flag"), proj_dir=i("proj_dir"),
        gripper=GripperState(pos=f("g_pos"), rot=f("g_rot"),
                             dist=f("g_dist"), pad_local=f("g_pad_local")),
    )
