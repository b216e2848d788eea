"""Bouncing task: a plastic-arched cloth bridge on a table; the bending
stiffness Kb is the differentiable system parameter. No effector
(counterpart of `thinshelllab_tpu/scenes/bouncing.py`; reference
task_scene/Scene_bouncing.py).

dt=2e-3, k_contact=4e4, init_ref_angle_bridge pre-sets a 1.7 rad plastic
arch, one-directional table->cloth contact only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.builder import SceneBuilder
from . import base, cloth_init


def make(cloth_size=0.06, kb=150.0, mu_cloth_elastic=0.5, solver="dense",
         dtype=torch.float64, max_newton_iter=50) -> base.TaskScene:
    N = M = 15
    dx = cloth_size / N
    b = SceneBuilder(
        dt=2e-3, k_contact=40000.0, eps_contact=4e-4, eps_v=1e-2, damping=1.0,
        max_newton_iter=max_newton_iter, gravity=(0.0, 0.0, -9.8),
        plastic=True, solver=solver, dtype=dtype,
    )
    cloth = b.add_cloth(N, M, cloth_size, rho=40.0, kb=kb,
                        init_pos=cloth_init.grid_flat(N, M, dx, -0.03, -0.03,
                                                      0.00039))
    table = b.add_cube_elastic(9, 9, 2, 0.07, (-0.035, -0.035, -0.00875),
                               E=5e5, nu=0.0)
    mu = b.new_mu_slot(mu_cloth_elastic)
    # reference: only table faces -> cloth vertices (Scene_bouncing:91-97)
    b.add_contact_pair(table, cloth, mu)

    def frozen_fn(bb, frozen):
        vs, ve = bb.vrange(table)
        frozen[vs:ve] = True

    b.freeze(frozen_fn)
    spec, state0, params = b.build()
    ref0 = cloth_init.ref_angle_bridge(b.bodies[cloth].cloth_mesh, M, 1.7)
    state0 = state0.replace(ref_angle=np.asarray(ref0, state0.ref_angle.dtype))

    cloth_nv = (N + 1) * (M + 1)
    rows = np.arange(cloth_nv) // (M + 1)
    mask = (rows == 5) | (rows == 10)

    def reward(buffers):
        z = buffers["pos"][-1, :cloth_nv, 2]
        keep = torch.as_tensor(mask, device=z.device)
        return torch.sum(torch.where(keep, z, torch.zeros_like(z)))

    def seed_loss(buffers):
        # get_loss_table (analytic_grad_system.py:180): dL/dz = -1 on rows
        # 5 and 10 at every step >= 1
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        pg[1:, :cloth_nv, 2] = base.like(np.where(mask, -1.0, 0.0), pos)
        return pg, pos.new_zeros((T, NH))

    return base.TaskScene(
        name="bouncing", spec=spec, state0=state0, params=params, n_part=0,
        rewards={"default": reward}, seed_loss=seed_loss, sys_param="kb",
        builder=b,
    )
