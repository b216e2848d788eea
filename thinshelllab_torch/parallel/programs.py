"""Rank programs for `mesh.launch`.

A spawned rank receives its function by qualified name and its arguments
by pickle. A TaskScene cannot be sent (its rewards and loss seeds are
closures), so each program here rebuilds its scene on the rank from the
registry name and keyword settings, and takes its actions, trajectory and
initial positions as numpy arrays. `sequence` runs several programs in
one launch, so that the ranks start once.

    launch(programs.population_rewards, 2, "cpu", "folding",
           dict(table_n=4), actions)
"""
from __future__ import annotations

import torch

from ..ops import dia_spmv
from ..scenes import registry
from ..train.cmaes import CMAESDriver
from .mesh import sharded_population_rewards, sharded_train_step


def scene_on(mesh, name, scene_kw, pos0=None):
    """(TaskScene, spec, state0, params) of registry scene `name` on the
    mesh's device, its initial positions replaced by pos0 where given."""
    sc = registry.make_scene(name, **scene_kw)
    spec, s0, params = sc.to(mesh.device)
    if pos0 is not None:
        s0 = s0.replace(pos=torch.as_tensor(pos0, dtype=spec.dtype,
                                            device=mesh.device))
    return sc, spec, s0, params


def as_tensors(arrays, spec, device):
    return tuple(torch.as_tensor(a, dtype=spec.dtype, device=device)
                 for a in arrays)


def population_rewards(mesh, name, scene_kw, actions, pos0=None,
                       reward="default"):
    """sharded_population_rewards of the (B, T, ...) actions on scene
    `name`: the (B,) rewards."""
    sc, spec, s0, params = scene_on(mesh, name, scene_kw, pos0)
    return sharded_population_rewards(
        mesh, spec, params, s0, as_tensors(actions, spec, mesh.device),
        sc.rewards[reward])


def train_step(mesh, name, scene_kw, actions, traj, lr=1e-3, pos0=None):
    """sharded_train_step on scene `name` with its own loss seeds:
    {"new_traj", "loss", "launches"} (the DIA kernel launches of this
    rank's step)."""
    sc, spec, s0, params = scene_on(mesh, name, scene_kw, pos0)
    dia_spmv.reset_launches()
    new_traj, loss = sharded_train_step(
        mesh, spec, params, s0, sc.seed_loss,
        as_tensors(actions, spec, mesh.device),
        torch.as_tensor(traj, dtype=spec.dtype, device=mesh.device), lr)
    return {"new_traj": new_traj, "loss": loss,
            "launches": dict(dia_spmv.LAUNCHES)}


def cmaes_generation(mesh, name, scene_kw, driver_kw):
    """One CMAESDriver generation over the mesh on scene `name`: the
    generation's dict with the strategy's mean and sigma after tell."""
    drv = CMAESDriver(registry.make_scene(name, **scene_kw), mesh=mesh,
                      **driver_kw)
    info = drv.generation()
    return dict(info, mean=drv.es.mean, sigma=drv.es.sigma)


def sequence(mesh, calls):
    """Run each (program, args) of `calls` in turn; their results."""
    return [fn(mesh, *args) for fn, args in calls]
