"""Balancing / throwing task: a soft ball rests on a sheet pinched between
two paired-pad grippers; keep it centred, or throw it upward (counterpart
of `thinshelllab_tpu/scenes/balancing.py`; reference
task_scene/Scene_balancing.py).

Paired gripper, eps_contact 0.00041, the ball from the port's own copy of
ball.node/.ele/.face at density 10000. The pre-grasped warm start the
trajopt CLI starts from is the port's own copy of `balance_state.npz`
(`bundled_state_path`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.builder import SceneBuilder
from . import base, cloth_init


def make(cloth_size=0.06, kb=100.0, mu_cloth_elastic=5.0, solver="dense",
         dtype=torch.float64, max_newton_iter=50) -> base.TaskScene:
    N, M = 15, 7
    dx = cloth_size / N
    b = SceneBuilder(
        dt=5e-3, k_contact=10000.0, eps_contact=0.00041, eps_v=1e-2,
        damping=1.0, max_newton_iter=max_newton_iter,
        gravity=(0.0, 0.0, -9.8), plastic=False, solver=solver, dtype=dtype,
    )
    cloth = b.add_cloth(N, M, cloth_size, rho=40.0, kb=kb,
                        init_pos=cloth_init.grid_flat(N, M, dx, -0.03, -0.015,
                                                      0.0))
    ball = b.add_ball_elastic((0.0, 0.0, 0.0039), density=10000.0, E=5e5,
                              nu=0.0, gravity_on=True)
    pads = [
        b.add_tactile((0.023, 0.0, 0.0079), flip=True, ratio=0.5),
        b.add_tactile((0.023, 0.0, -0.0079), flip=False, ratio=0.5),
        b.add_tactile((-0.023, 0.0, 0.0079), flip=True, ratio=0.5),
        b.add_tactile((-0.023, 0.0, -0.0079), flip=False, ratio=0.5),
    ]
    mu_ball = b.new_mu_slot(0.2)
    mu_ce = b.new_mu_slot(mu_cloth_elastic)
    for el, slot in [(ball, mu_ball)] + [(p, mu_ce) for p in pads]:
        b.add_contact_pair(cloth, el, slot)
        b.add_contact_pair(el, cloth, slot)

    def frozen_fn(bb, frozen):
        for p in pads:
            pvs, _ = bb.vrange(p)
            frozen[pvs + bb.bodies[p].tet_mesh.bound_idx] = True

    b.freeze(frozen_fn)
    b.set_gripper(
        "paired", pads, [0, 0, 1, 1], [+1, -1, +1, -1],
        np.array([[0.023, 0.0, 0.0], [-0.023, 0.0, 0.0]]),
    )
    spec, state0, params = b.build()

    bs, be = spec.body_v_start[1], spec.body_v_end[1]
    center = (N + 1) // 2 * (M + 1) + (M + 1) // 2
    e1 = np.arange(M + 1)
    e2 = N * (M + 1) + np.arange(M + 1)

    def reward(buffers):
        bpos = buffers["pos"][-1, bs:be, :2]
        cpos = buffers["pos"][-1, center, :2]
        return -torch.sum((bpos - cpos[None]) ** 2)

    def reward_all(buffers):
        bpos = buffers["pos"][:, bs:be, :2]
        cpos = buffers["pos"][:, center, :2]
        return -torch.sum((bpos - cpos[:, None]) ** 2)

    def reward_throwing(buffers):
        z = buffers["pos"][-1, :, 2]
        return (torch.sum(z[bs:be]) - 10 * torch.sum(z[e1] ** 2)
                - 10 * torch.sum(z[e2] ** 2))

    def seed_loss(buffers):
        # get_loss_balance: per-step 2(dx) pair pulls ball toward sheet center
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        d = pos[1:, bs:be, :2] - pos[1:, center, None, :2]
        pg[1:, bs:be, :2] = 2.0 * d
        pg[1:, center, :2] = -2.0 * torch.sum(d, dim=1)
        return pg, pos.new_zeros((T, NH))

    def seed_loss_throwing(buffers):
        pos = buffers["pos"]
        T = pos.shape[0]
        NH = spec.cloth.hinge_verts.shape[0]
        pg = pos.new_zeros((T, spec.NV, 3))
        pg[1:, bs:be, 2] = -1.0
        pg[1:, e1, 2] = 20.0 * pos[1:, e1, 2]
        pg[1:, e2, 2] = 20.0 * pos[1:, e2, 2]
        return pg, pos.new_zeros((T, NH))

    sc = base.TaskScene(
        name="balancing", spec=spec, state0=state0, params=params, n_part=2,
        rewards={"default": reward, "compute_reward_all": reward_all,
                 "compute_reward_throwing": reward_throwing,
                 # RL variant (Scene_balancing.compute_reward_throwing_RL:
                 # 170-181): the same objective on the final state
                 "compute_reward_throwing_RL": reward_throwing},
        seed_loss=seed_loss,
        seed_losses={"compute_reward_throwing": seed_loss_throwing,
                     "compute_reward_throwing_RL": seed_loss_throwing},
        builder=b,
    )
    sc.seed_loss_throwing = seed_loss_throwing
    return sc


def make_grasped_state(scene, close_dist=-0.002, close_steps=10,
                       settle_steps=5, device=None):
    """Pre-grasp warm start: close the paired gripper onto the sheet, then
    settle (the equivalent of the reference's shipped `data/balance_state`,
    Scene_balancing.load_all:202-222). Returns the final SimState on
    `device` (default the card; no card raises)."""
    from ..engine import stepper

    spec, state0, params = scene.to(device)
    T = close_steps + settle_steps
    dd = torch.zeros((T, scene.n_part), dtype=spec.dtype,
                     device=state0.pos.device)
    dd[:close_steps] = close_dist / close_steps
    acts = (torch.zeros((T, scene.n_part, 3), dtype=spec.dtype,
                        device=dd.device),
            torch.zeros((T, scene.n_part, 3), dtype=spec.dtype,
                        device=dd.device),
            dd)
    st, _ = stepper.rollout(spec, params, state0, acts)
    return st


def bundled_state_path():
    """Path of the port's copy of the packaged pre-grasped warm start."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "balance_state.npz")
