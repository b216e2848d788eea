"""Folding task: create a sharp crease in a pre-curled paper strip
(counterpart of `thinshelllab_tpu/scenes/folding.py`; reference
task_scene/Scene_folding.py).

One 15x3 cloth strip pre-curled at row 7/8 (plastic, k_angle=0.5), a
9x9x2 table elastic, one flipped tactile pad on a single-pad gripper; zero
gravity; k_contact=1e4, dt=5e-3, Newton cap 50. Reward:
-sum(ref_angle * curve7) over row-6->8 hinges and -sum(ref_angle * curve8)
over row-7->9 hinges (:130-147).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.builder import SceneBuilder
from . import base, cloth_init


def make(cloth_size=0.1, kb=400.0, mu_cloth_elastic=5.0, curve7=1.0,
         curve8=-1.0, tot_timestep=50, solver="dense", dtype=torch.float64,
         cloth_N=15, cloth_M=3, table_n=9, max_newton_iter=50) -> base.TaskScene:
    N, M = cloth_N, cloth_M
    dx = cloth_size / N
    b = SceneBuilder(
        dt=5e-3,
        k_contact=10000.0,
        eps_contact=4e-4,
        eps_v=1e-2,
        damping=1.0,
        max_newton_iter=max_newton_iter,
        gravity=(0.0, 0.0, 0.0),
        plastic=True,
        solver=solver,
        dtype=dtype,
    )
    cloth_pos = cloth_init.grid_fold(N, M, dx, -0.07, -0.01, 0.0004, 2)
    cloth = b.add_cloth(N, M, cloth_size, rho=40.0, init_pos=cloth_pos,
                        kl=1000.0, ka=1000.0, kb=kb, k_angle=0.5)
    # table top sits at z = 0: the z-offset is -dx of the lattice
    # (reference offset -0.00875 = -0.07/8 for the 9x9x2 table)
    table_dx = 0.07 / (table_n - 1)
    table = b.add_cube_elastic(table_n, table_n, 2, 0.07,
                               (-0.035, -0.035, -table_dx), E=5e5, nu=0.0)
    r = cloth_init.fold_radius(dx, 2)
    x = -0.07 + (7 + 2) / 16 * 0.1 - r * 0.86 + 0.005
    pad = b.add_tactile((x, 0.0, 2 * r + 0.0079), flip=True, ratio=0.5)

    mu = b.new_mu_slot(mu_cloth_elastic)
    for el in (table, pad):
        b.add_contact_pair(cloth, el, mu)
        b.add_contact_pair(el, cloth, mu)

    def frozen_fn(bb, frozen):
        vs, ve = bb.vrange(table)
        frozen[vs:ve] = True
        pvs, _ = bb.vrange(pad)
        mesh = bb.bodies[pad].tet_mesh
        frozen[pvs + mesh.bound_idx] = True
        cvs, _ = bb.vrange(cloth)
        far = cvs + N * (M + 1) + np.arange(M + 1)
        frozen[far] = True

    b.freeze(frozen_fn)
    b.set_gripper("single", [pad], [0], [0], np.array([[x, 0.0, 2 * r + 0.0079]]))

    spec, state0, params = b.build()
    state0 = base.with_pre_curl_ref_angle(spec, state0)

    mask7 = base.hinge_row_mask(b, cloth, 6, 8)
    mask8 = base.hinge_row_mask(b, cloth, 7, 9)

    def reward(buffers, c7=curve7, c8=curve8):
        ref = buffers["ref_angle"][-1]
        return -(c7 * torch.sum(ref * base.like(mask7, ref))
                 + c8 * torch.sum(ref * base.like(mask8, ref)))

    def reward_7(buffers):
        return reward(buffers, 1.0, -1.0)

    def reward_8(buffers):
        return reward(buffers, -1.0, 1.0)

    def seed_loss(buffers):
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pos_grad = pos.new_zeros((T, spec.NV, 3))
        ar = pos.new_zeros((T, NH))
        ar[T - 1] = (curve7 * base.like(mask7, pos)
                     + curve8 * base.like(mask8, pos))
        return pos_grad, ar

    return base.TaskScene(
        name="folding",
        spec=spec,
        state0=state0,
        params=params,
        n_part=1,
        rewards={"default": reward, "compute_reward_7": reward_7,
                 "compute_reward_8": reward_8},
        seed_loss=seed_loss,
        max_moving_dist=0.001,
        builder=b,
    )
