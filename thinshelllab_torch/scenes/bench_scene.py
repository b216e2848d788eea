"""Benchmark scene: a cloth draped on an elastic table with a tactile pad
pressing down (counterpart of `thinshelllab_tpu/scenes/bench_scene.py`).
At cloth_N=70 the cloth has 9,800 triangles; the scene then has 5,605
vertices, a 71-offset DIA plan and 10,752 contact slots."""
from __future__ import annotations

import numpy as np
import torch

from ..core.builder import SceneBuilder
from . import base, cloth_init


def make(cloth_N=70, dtype=torch.float32, solver="cg", max_newton_iter=8,
         table_n=12, cg_max_iter=200, cg_tol=1e-6, fwd_tol=None,
         adj_tol=None, hess_refresh=1, spmv="auto",
         grid_h=3e-3) -> base.TaskScene:
    N = M = cloth_N
    size = 0.1
    dx = size / N
    b = SceneBuilder(
        dt=5e-3,
        grid_h=grid_h,
        k_contact=10000.0,
        eps_contact=4e-4,
        eps_v=1e-2,
        damping=1.0,
        max_newton_iter=max_newton_iter,
        spmv=spmv,
        gravity=(0.0, 0.0, -9.8),
        plastic=False,
        solver=solver,
        dtype=dtype,
        hess_refresh=hess_refresh,
    )
    cloth_pos = cloth_init.grid_flat(N, M, dx, -0.05, -0.05, 0.0006)
    cloth = b.add_cloth(N, M, size, rho=40.0, init_pos=cloth_pos)
    table_dx = 0.12 / (table_n - 1)
    table = b.add_cube_elastic(table_n, table_n, 2, 0.12,
                               (-0.06, -0.06, -table_dx), E=5e5, nu=0.0)
    pad = b.add_tactile((0.0, 0.0, 0.0085), flip=True, ratio=0.5)

    mu = b.new_mu_slot(1.0)
    for el in (table, pad):
        b.add_contact_pair(cloth, el, mu)
        b.add_contact_pair(el, cloth, mu)

    def frozen_fn(bb, frozen):
        vs, ve = bb.vrange(table)
        frozen[vs:ve] = True
        pvs, _ = bb.vrange(pad)
        frozen[pvs + bb.bodies[pad].tet_mesh.bound_idx] = True

    b.freeze(frozen_fn)
    b.set_gripper("single", [pad], [0], [0], np.array([[0.0, 0.0, 0.0085]]))

    spec, state0, params = b.build()
    spec = spec.replace(cg_max_iter=cg_max_iter, cg_tol=cg_tol,
                        fwd_tol=fwd_tol, adj_tol=adj_tol,
                        spd_method="shift")

    cloth_nv = (N + 1) * (M + 1)

    def reward(buffers):
        return -torch.sum(buffers["pos"][-1, :cloth_nv, 2])

    def seed_loss(buffers):
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = torch.zeros((T, spec.NV, 3), dtype=pos.dtype, device=pos.device)
        pg[T - 1, :cloth_nv, 2] = 1.0
        return pg, torch.zeros((T, NH), dtype=pos.dtype, device=pos.device)

    return base.TaskScene(
        name="bench",
        spec=spec,
        state0=state0,
        params=params,
        n_part=1,
        rewards={"default": reward},
        seed_loss=seed_loss,
        builder=b,
    )
