"""Lifting task: move the soft box resting on the sheet by (-12mm, -12mm)
using one top pad and two bottom pads (counterpart of
`thinshelllab_tpu/scenes/lifting.py`; reference task_scene/Scene_lifting.py).

k_contact=500, Newton cap 15, a 5^3 box of density 20000 under gravity on
a zero-gravity cloth.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.builder import SceneBuilder
from . import base, cloth_init


def make(cloth_size=0.06, kb=100.0, mu_cloth_elastic=5.0, solver="dense",
         dtype=torch.float64, max_newton_iter=15) -> base.TaskScene:
    N = M = 15
    dx = cloth_size / N
    b = SceneBuilder(
        dt=5e-3, k_contact=500.0, eps_contact=4e-4, eps_v=1e-2, damping=1.0,
        max_newton_iter=max_newton_iter, gravity=(0.0, 0.0, -9.8),
        plastic=False, solver=solver, dtype=dtype,
    )
    cloth = b.add_cloth(N, M, cloth_size, rho=40.0,
                        init_pos=cloth_init.grid_flat(N, M, dx, -0.03, -0.03,
                                                      0.0),
                        kb=kb, gravity_on=False)
    box = b.add_cube_elastic(5, 5, 5, 0.007, (-0.025, -0.005, 0.0003),
                             density=20000.0, E=5e5, nu=0.0, gravity_on=True)
    pads = [
        b.add_tactile((0.01, 0.0, 0.0079), flip=True, ratio=0.5),
        b.add_tactile((0.0, -0.015, -0.0079), flip=False, ratio=0.5),
        b.add_tactile((0.0, 0.015, -0.0079), flip=False, ratio=0.5),
    ]
    mu = b.new_mu_slot(mu_cloth_elastic)
    for el in [box] + pads:
        b.add_contact_pair(cloth, el, mu)
        b.add_contact_pair(el, cloth, mu)

    def frozen_fn(bb, frozen):
        for p in pads:
            vs, _ = bb.vrange(p)
            frozen[vs + bb.bodies[p].tet_mesh.bound_idx] = True

    b.freeze(frozen_fn)
    b.set_gripper(
        "single", pads, [0, 1, 2], [0, 0, 0],
        np.array([[0.01, 0.0, 0.0079], [0.0, -0.015, -0.0079],
                  [0.0, 0.015, -0.0079]]),
    )
    spec, state0, params = b.build()
    bs, be = spec.body_v_start[1], spec.body_v_end[1]
    pos0_box = np.array(state0.pos[bs:be])
    target_delta = [-0.012, -0.012, 0.0]

    def reward(buffers):
        pos = buffers["pos"]
        d = (pos[-1, bs:be] - base.like(pos0_box, pos)
             - base.like(target_delta, pos))
        return -torch.sum(d * d)

    def seed_loss(buffers):
        # reference get_loss_lift (analytic_grad_single.py:303-312): seeds
        # (pos - pos0 + 0.012) per axis, without the factor 2
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        pg[T - 1, bs:be] = (pos[T - 1, bs:be] - pos[0, bs:be]
                            + base.like([0.012, 0.012, 0.0], pos))
        return pg, pos.new_zeros((T, NH))

    return base.TaskScene(
        name="lifting", spec=spec, state0=state0, params=params, n_part=3,
        rewards={"default": reward}, seed_loss=seed_loss, builder=b,
    )
