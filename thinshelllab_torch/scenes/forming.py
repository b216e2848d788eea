"""Forming task: press a pre-curled strip into a target shape (counterpart
of `thinshelllab_tpu/scenes/forming.py`; reference
task_scene/Scene_forming.py).

A 15x7 strip pre-curled at half_curv_num=3, k_contact=2e4; the target
defaults to the flat grid.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.builder import SceneBuilder
from . import base, cloth_init


def make(cloth_size=0.06, kb=200.0, mu_cloth_elastic=5.0, target_pos=None,
         solver="dense", dtype=torch.float64,
         max_newton_iter=50) -> base.TaskScene:
    N, M = 15, 7
    dx = cloth_size / N
    b = SceneBuilder(
        dt=5e-3, k_contact=20000.0, eps_contact=4e-4, eps_v=1e-2, damping=1.0,
        max_newton_iter=max_newton_iter, gravity=(0.0, 0.0, 0.0),
        plastic=True, solver=solver, dtype=dtype,
    )
    cloth_pos = cloth_init.grid_fold(N, M, dx, -0.07, -0.02, 0.00035, 3)
    cloth = b.add_cloth(N, M, cloth_size, rho=40.0, kb=kb,
                        init_pos=cloth_pos)
    table = b.add_cube_elastic(9, 9, 2, 0.07, (-0.035, -0.035, -0.00875),
                               E=5e5, nu=0.0)
    r = cloth_init.fold_radius(dx, 3)
    x = -0.07 + (7 + 3) / 16 * 0.1 - r * 0.86 + 0.01
    pad = b.add_tactile((x, 0.0, 2 * r + 0.00785), flip=True, ratio=0.5)

    mu = b.new_mu_slot(mu_cloth_elastic)
    for el in (table, pad):
        b.add_contact_pair(cloth, el, mu)
        b.add_contact_pair(el, cloth, mu)

    def frozen_fn(bb, frozen):
        vs, ve = bb.vrange(table)
        frozen[vs:ve] = True
        pvs, _ = bb.vrange(pad)
        frozen[pvs + bb.bodies[pad].tet_mesh.bound_idx] = True
        cvs, _ = bb.vrange(cloth)
        frozen[cvs + N * (M + 1) + np.arange(M + 1)] = True

    b.freeze(frozen_fn)
    b.set_gripper("single", [pad], [0], [0],
                  np.array([[x, 0.0, 2 * r + 0.00785]]))
    spec, state0, params = b.build()
    state0 = base.with_pre_curl_ref_angle(spec, state0)

    cloth_nv = (N + 1) * (M + 1)
    if target_pos is None:
        target_pos = cloth_init.grid_flat(N, M, dx, -0.07, -0.02, 0.00035)
    target = np.asarray(target_pos)

    def reward(buffers):
        pos = buffers["pos"]
        d = pos[-1, :cloth_nv] - base.like(target, pos)
        return -torch.sum(d * d)

    def seed_loss(buffers):
        # get_loss_push: dL/dx = 2 (x - target) at the final step
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        pg[T - 1, :cloth_nv] = 2.0 * (pos[T - 1, :cloth_nv]
                                      - base.like(target, pos))
        return pg, pos.new_zeros((T, NH))

    return base.TaskScene(
        name="forming", spec=spec, state0=state0, params=params, n_part=1,
        rewards={"default": reward}, seed_loss=seed_loss, builder=b,
    )
