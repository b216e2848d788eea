"""Card task: slide the bottom card out of a 3-card stack with two rotated
side pads and one top pad; Kb is the system-ID parameter (counterpart of
`thinshelllab_tpu/scenes/card.py`; reference task_scene/Scene_card.py).

12x8 cards, k_contact=2e4, damping=0.95, side pads rotated +-90 deg about
y, elastic->cloth contact pairs only, the upper cards with 10x friction.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.builder import SceneBuilder
from ..utils.quaternion import quat_to_rotmat
from . import base, cloth_init


def make(cloth_size=0.06, kb=100.0, mu_cloth_elastic=1.0, solver="dense",
         dtype=torch.float64, max_newton_iter=50) -> base.TaskScene:
    N, M = 12, 8
    dx = cloth_size / N
    b = SceneBuilder(
        dt=5e-3, k_contact=20000.0, eps_contact=4e-4, eps_v=1e-2,
        damping=0.95, max_newton_iter=max_newton_iter,
        gravity=(0.0, 0.0, 0.0), plastic=True, solver=solver, dtype=dtype,
    )
    cloths = [
        b.add_cloth(N, M, cloth_size, rho=40.0, kb=kb,
                    init_pos=cloth_init.grid_flat(N, M, dx, -0.02, -0.02, z))
        for z in (0.01, 0.0104, 0.0108)
    ]
    table = b.add_cube_elastic(9, 9, 2, 0.07, (-0.025, -0.025, -0.00875),
                               E=5e5, nu=0.0)
    pads = [
        b.add_tactile((-0.0285, 0.0, 0.01), flip=False, ratio=0.5),
        b.add_tactile((0.0485, 0.0, 0.01), flip=False, ratio=0.5),
        b.add_tactile((0.01, 0.0, 0.0185), flip=True, ratio=0.5),
    ]
    mu_cc = b.new_mu_slot(0.1)
    mu_ce = b.new_mu_slot(mu_cloth_elastic)
    mu_ce10 = b.new_mu_slot(mu_cloth_elastic * 10)
    for i in range(3):
        for j in range(3):
            if abs(i - j) == 1:
                b.add_contact_pair(cloths[i], cloths[j], mu_cc)
    # reference: elastic -> cloth vertices only (Scene_card:122-129)
    for i, c in enumerate(cloths):
        slot = mu_ce if i == 0 else mu_ce10
        for el in [table] + pads:
            b.add_contact_pair(el, c, slot)

    def frozen_fn(bb, frozen):
        vs, ve = bb.vrange(table)
        frozen[vs:ve] = True
        for p in pads:
            pvs, _ = bb.vrange(p)
            frozen[pvs + bb.bodies[p].tet_mesh.bound_idx] = True

    b.freeze(frozen_fn)
    part_pos = np.array([[-0.0285, 0.0, 0.01], [0.0485, 0.0, 0.01],
                         [0.01, 0.0, 0.0185]])
    b.set_gripper("single", pads, [0, 1, 2], [0, 0, 0], part_pos)
    spec, state0, params = b.build()

    # side pads rotated +-90 deg about y at init (Scene_card:90-94); the
    # rotation, in the scene's dtype, is applied rigidly to ALL pad
    # vertices (update_all)
    s2 = np.sqrt(2.0) * 0.5
    rot = np.array(state0.gripper.rot)
    rot[0] = (s2, 0.0, s2, 0.0)
    rot[1] = (s2, 0.0, -s2, 0.0)
    pos = np.array(state0.pos)
    R = quat_to_rotmat(torch.as_tensor(rot)).numpy()
    for p in range(2):
        off = spec.gripper.pad_offset[p]
        nv = spec.gripper.n_pad_verts
        local = np.array(state0.gripper.pad_local[p])
        pos[off : off + nv] = part_pos[p] + local @ R[p].T
    gs = state0.gripper.replace(rot=rot.astype(pos.dtype))
    state0 = state0.replace(pos=pos, gripper=gs)

    cloth_nv = (N + 1) * (M + 1)
    row8 = np.where(np.arange(cloth_nv) // (M + 1) == 8, -1.0, 0.0)

    def reward(buffers):
        return -torch.sum(buffers["pos"][-1, :cloth_nv, 0])

    def seed_loss(buffers):
        # get_loss_card (analytic_grad_single.py:385): dL/dz = -1 on row-8
        # vertices of cloth 0 at every step
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        pg[:, :cloth_nv, 2] = base.like(row8, pos)
        return pg, pos.new_zeros((T, NH))

    return base.TaskScene(
        name="card", spec=spec, state0=state0, params=params, n_part=3,
        rewards={"default": reward}, seed_loss=seed_loss, sys_param="kb",
        builder=b,
    )
