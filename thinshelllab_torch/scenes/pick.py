"""Pick / pick-and-fold task: lift row 8 of the sheet off an arched table
with two pads, optionally creating a crease (plastic k_angle=0.5)
(counterpart of `thinshelllab_tpu/scenes/pick.py`; reference
task_scene/Scene_pick.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.builder import SceneBuilder
from . import base, cloth_init


def make(cloth_size=0.06, kb=200.0, mu_cloth_elastic=10.0, solver="dense",
         dtype=torch.float64, max_newton_iter=50) -> base.TaskScene:
    N = M = 16
    dx = cloth_size / N
    b = SceneBuilder(
        dt=5e-3, k_contact=10000.0, eps_contact=4e-4, eps_v=1e-2, damping=1.0,
        max_newton_iter=max_newton_iter, gravity=(0.0, 0.0, -9.8),
        plastic=True, solver=solver, dtype=dtype,
    )
    cloth = b.add_cloth(N, M, cloth_size, rho=40.0, kb=kb, k_angle=0.5,
                        init_pos=cloth_init.grid_flat(N, M, dx, -0.03, -0.03,
                                                      0.0004))
    table = b.add_cube_elastic(16, 16, 2, 0.06, (-0.03, -0.03, -0.008),
                               E=5e5, nu=0.0, arch=0.004)
    pads = [
        b.add_tactile((-0.025, 0.0, 0.0079), flip=True, ratio=0.5),
        b.add_tactile((0.025, 0.0, 0.0079), flip=True, ratio=0.5),
    ]
    mu_t = b.new_mu_slot(0.1)
    mu_ce = b.new_mu_slot(mu_cloth_elastic)
    for el, slot in [(table, mu_t)] + [(p, mu_ce) for p in pads]:
        b.add_contact_pair(cloth, el, slot)
        b.add_contact_pair(el, cloth, slot)

    def frozen_fn(bb, frozen):
        vs, ve = bb.vrange(table)
        frozen[vs:ve] = True
        for p in pads:
            pvs, _ = bb.vrange(p)
            frozen[pvs + bb.bodies[p].tet_mesh.bound_idx] = True

    b.freeze(frozen_fn)
    b.set_gripper("single", pads, [0, 1], [0, 0],
                  np.array([[-0.025, 0.0, 0.0079], [0.025, 0.0, 0.0079]]))
    spec, state0, params = b.build()

    cloth_nv = (N + 1) * (M + 1)
    row8 = np.arange(cloth_nv) // (M + 1) == 8
    mask79 = base.hinge_row_mask(b, cloth, 7, 9)

    def reward(buffers):
        z = buffers["pos"][-1, :cloth_nv, 2]
        keep = torch.as_tensor(row8, device=z.device)
        return torch.sum(torch.where(keep, z, torch.zeros_like(z)))

    def reward_pick_fold(buffers):
        # ref angle over row 7->9 hinges (Scene_pick:139-152)
        ref = buffers["ref_angle"][-1]
        return torch.sum(ref * base.like(mask79, ref))

    def seed_loss(buffers):
        # get_loss_pick: dL/dz = -1 on row-8 verts at every step
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        pg[:, :cloth_nv, 2] = base.like(np.where(row8, -1.0, 0.0), pos)
        return pg, pos.new_zeros((T, NH))

    def seed_loss_pick_fold(buffers):
        # get_loss_pick_fold: dL/dref = -1 on row 7->9 hinges at every step
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        ar = pos.new_zeros((T, NH))
        ar[:] = base.like(np.where(mask79, -1.0, 0.0), pos)
        return pos.new_zeros((T, spec.NV, 3)), ar

    sc = base.TaskScene(
        name="pick", spec=spec, state0=state0, params=params, n_part=2,
        rewards={"default": reward,
                 "compute_reward_pick_fold": reward_pick_fold},
        seed_loss=seed_loss,
        seed_losses={"compute_reward_pick_fold": seed_loss_pick_fold},
        builder=b,
    )
    sc.seed_loss_pick_fold = seed_loss_pick_fold
    return sc
