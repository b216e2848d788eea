"""Sliding (separating) task: slide the top sheet of a 3-sheet stack; the
cloth-cloth friction coefficient is the system-ID parameter (counterpart
of `thinshelllab_tpu/scenes/sliding.py`; reference
task_scene/Scene_sliding.py).

The pad is stiffened to E=5e5/nu=0.2, cloth-table mu=0.4, and the
learnable mu_cloth_cloth (slot 0) acts on adjacent sheet pairs.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.builder import SceneBuilder
from . import base, cloth_init


def make(cloth_size=0.06, kb=1000.0, mu_cloth_cloth=0.5, mu_cloth_elastic=1.0,
         solver="dense", dtype=torch.float64,
         max_newton_iter=50) -> base.TaskScene:
    N = M = 15
    dx = cloth_size / N
    b = SceneBuilder(
        dt=5e-3, k_contact=10000.0, eps_contact=4e-4, eps_v=1e-2, damping=1.0,
        max_newton_iter=max_newton_iter, gravity=(0.0, 0.0, 0.0),
        plastic=True, solver=solver, dtype=dtype,
    )
    cloths = [
        b.add_cloth(N, M, cloth_size, rho=40.0, kb=kb,
                    init_pos=cloth_init.grid_flat(N, M, dx, -0.03, -0.03, z))
        for z in (0.0004, 0.0008, 0.0012)
    ]
    table = b.add_cube_elastic(16, 16, 2, 0.1, (-0.05, -0.05, -0.00666),
                               E=5e5, nu=0.0)
    pad = b.add_tactile((0.0, 0.0, 0.0105), flip=True, ratio=0.5, E=5e5,
                        nu=0.2)

    mu_cc = b.new_mu_slot(mu_cloth_cloth)   # learnable slot
    mu_ct = b.new_mu_slot(0.4)
    mu_ce = b.new_mu_slot(mu_cloth_elastic)
    for i in range(3):
        for j in range(3):
            if abs(i - j) == 1:
                b.add_contact_pair(cloths[i], cloths[j], mu_cc)
    for c in cloths:
        for el, slot in ((table, mu_ct), (pad, mu_ce)):
            b.add_contact_pair(c, el, slot)
            b.add_contact_pair(el, c, slot)

    def frozen_fn(bb, frozen):
        vs, ve = bb.vrange(table)
        frozen[vs:ve] = True
        pvs, _ = bb.vrange(pad)
        frozen[pvs + bb.bodies[pad].tet_mesh.bound_idx] = True

    b.freeze(frozen_fn)
    b.set_gripper("single", [pad], [0], [0], np.array([[0.0, 0.0, 0.0105]]))
    spec, state0, params = b.build()
    cloth_nv = (N + 1) * (M + 1)

    def reward(buffers):
        return -torch.sum(buffers["pos"][-1, :cloth_nv, 0])

    def seed_loss(buffers):
        # get_loss_sheet (analytic_grad_single.py:266): dL/dx = +1 on cloth0
        # x for every step >= 1
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        pg[1:, :cloth_nv, 0] = 1.0
        return pg, pos.new_zeros((T, NH))

    return base.TaskScene(
        name="sliding", spec=spec, state0=state0, params=params, n_part=1,
        rewards={"default": reward}, seed_loss=seed_loss,
        sys_param="mu_pair:0", builder=b,
    )
