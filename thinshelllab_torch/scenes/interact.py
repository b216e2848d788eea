"""Interact task: push a dense box to the right using the sheet held by a
paired gripper, the grip closing during the first 5 frames (counterpart of
`thinshelllab_tpu/scenes/interact.py`; reference
task_scene/Scene_interact.py).

k_contact=3e4, an extra 6x6x4 box of density `dense`, box<->table contact
at mu=0.1, a forced closing action for step < 5 (`grip_close_actions`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.builder import SceneBuilder
from . import base, cloth_init


def make(cloth_size=0.06, kb=100.0, mu_cloth_elastic=5.0, dense=10000.0,
         solver="dense", dtype=torch.float64,
         max_newton_iter=50) -> base.TaskScene:
    N = M = 15
    dx = cloth_size / N
    b = SceneBuilder(
        dt=5e-3, k_contact=30000.0, eps_contact=4e-4, eps_v=1e-2, damping=1.0,
        max_newton_iter=max_newton_iter, gravity=(0.0, 0.0, -9.8),
        plastic=False, solver=solver, dtype=dtype,
    )
    cloth = b.add_cloth(N, M, cloth_size, rho=40.0, kb=kb,
                        init_pos=cloth_init.grid_flat(N, M, dx, -0.045, -0.03,
                                                      0.0004))
    table = b.add_cube_elastic(16, 16, 2, 0.06, (-0.03, -0.03, -0.004),
                               E=5e5, nu=0.0)
    pads = [
        b.add_tactile((-0.04, 0.0, 0.0083), flip=True, ratio=0.5),
        b.add_tactile((-0.04, 0.0, -0.0075), flip=False, ratio=0.5),
    ]
    box = b.add_cube_elastic(6, 6, 4, 0.012, (0.001, -0.006, 0.0008),
                             density=dense, E=5e5, nu=0.0, gravity_on=True)

    mu_02 = b.new_mu_slot(0.2)
    mu_ce = b.new_mu_slot(mu_cloth_elastic)
    mu_01 = b.new_mu_slot(0.1)
    for el, slot in [(table, mu_02), (pads[0], mu_ce), (pads[1], mu_ce),
                     (box, mu_02)]:
        b.add_contact_pair(cloth, el, slot)
        b.add_contact_pair(el, cloth, slot)
    b.add_contact_pair(table, box, mu_01)
    b.add_contact_pair(box, table, mu_01)

    def frozen_fn(bb, frozen):
        vs, ve = bb.vrange(table)
        frozen[vs:ve] = True
        for p in pads:
            pvs, _ = bb.vrange(p)
            frozen[pvs + bb.bodies[p].tet_mesh.bound_idx] = True

    b.freeze(frozen_fn)
    b.set_gripper("paired", pads, [0, 0], [+1, -1],
                  np.array([[-0.04, 0.0, 0.0004]]))
    spec, state0, params = b.build()

    cloth_nv = (N + 1) * (M + 1)
    bs, be = spec.body_v_start[4], spec.body_v_end[4]

    def reward(buffers):
        pos = buffers["pos"]
        return (-torch.sum(pos[-1, :cloth_nv, 0])
                + torch.sum(pos[-1, bs:be, 0]) * 256.0 / 144.0)

    def reward_1(buffers):
        return -torch.sum(buffers["pos"][-1, bs:be, 0])

    def seed_loss(buffers):
        # get_loss_interact: final-step +1 on cloth x, -256/144 on box x
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        pg[T - 1, :cloth_nv, 0] = 1.0
        pg[T - 1, bs:be, 0] = -256.0 / 144.0
        return pg, pos.new_zeros((T, NH))

    def seed_loss_1(buffers):
        # get_loss_interact_1 (analytic_grad_single.py:423-427): +1 on box x
        # at the final step only, the 'following' objective
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        pg[T - 1, bs:be, 0] = 1.0
        return pg, pos.new_zeros((T, NH))

    def grip_close_actions(actions, n_close=5, ddis=-0.0006):
        """Force the opening DOF closed for the first n_close steps
        (reference Scene_interact.action:165-170)."""
        dpos, drot, ddis_arr = actions
        ddis_arr = ddis_arr.clone()
        ddis_arr[:n_close] = ddis
        return dpos, drot, ddis_arr

    sc = base.TaskScene(
        name="interact", spec=spec, state0=state0, params=params, n_part=1,
        rewards={"default": reward, "compute_reward_1": reward_1},
        seed_loss=seed_loss,
        seed_losses={"compute_reward_1": seed_loss_1}, builder=b,
    )
    sc.grip_close_actions = grip_close_actions
    return sc
