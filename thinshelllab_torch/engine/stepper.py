"""The implicit time step and the rollout (counterpart of
`thinshelllab_tpu/engine/stepper.py`; reference BaseScene.time_step
:1327-1374).

  1. effector action: the rigid gripper update writes the pads' boundary
  2. snapshot prev_pos, vertex normals
  3. projection query (latched contact side) + contact analysis
  4. Newton on the incremental potential (full or modified)
  5. damped velocity update and the plastic reference-angle gate

The JAX rollout is a `lax.scan`; here it is a Python loop over steps.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.spec import (ContactSet, GripperState, Params, SceneSpec,
                         SimState)
from ..ops import collision, energies
from . import gripper, solver


class StepAux(NamedTuple):
    """Per-step saved quantities."""

    prev_pos: torch.Tensor
    contact_active: torch.Tensor
    newton_pos: torch.Tensor
    yield_gate: torch.Tensor
    contact: object = None


def update_ref_angle_gate(spec: SceneSpec, pos, ref_angle):
    """Plastic yield update (reference model_fold_offset.update_ref_angle
    :177-186): where |theta - ref| exceeds k_angle, ref moves to the yield
    surface. Also returns the boolean yield decisions."""
    c = spec.cloth
    theta = energies.hinge_angle(pos[c.hinge_verts], c.hinge_sel)
    k_angle = torch.as_tensor(c.k_angle, dtype=pos.dtype,
                              device=pos.device)[c.hinge_cloth]
    dis = theta - ref_angle
    absd = torch.abs(dis)
    yielded = (absd > k_angle) & c.hinge_mask
    new_ref = ref_angle + torch.where(yielded, (absd - k_angle) * torch.sign(dis),
                                      torch.zeros_like(dis))
    return new_ref, yielded


def update_ref_angle(spec: SceneSpec, pos, ref_angle):
    return update_ref_angle_gate(spec, pos, ref_angle)[0]


def build_contacts(spec: SceneSpec, params: Params, pos, prev_pos, proj_flag,
                   proj_dir):
    vn = collision.vertex_normals(pos, spec.faces, spec.NV)
    proj_flag, proj_dir, tri, w = collision.projection_query(
        spec, pos, vn, proj_flag, proj_dir)
    contact = collision.contact_analysis(
        spec, params.mu_pairs, pos, prev_pos, proj_flag, proj_dir, tri, w)
    return contact, proj_flag, proj_dir


def time_step(spec: SceneSpec, params: Params, state: SimState, action,
              stats=None):
    """action: (delta_pos (G,3), delta_rot (G,3), delta_dis (G,))."""
    delta_pos, delta_rot, delta_dis = (
        torch.as_tensor(a, dtype=spec.dtype, device=state.pos.device)
        for a in action)
    gs = gripper.gripper_step(spec, state.gripper, delta_pos, delta_rot,
                              delta_dis)
    pos = gripper.write_bound_vertices(spec, state.pos, gs)

    prev_pos = pos
    contact, proj_flag, proj_dir = build_contacts(
        spec, params, pos, prev_pos, state.proj_flag, state.proj_dir)
    new_pos = solver.newton_solve(spec, params, pos, prev_pos, state.vel,
                                  state.ref_angle, contact, stats=stats)
    new_vel = (new_pos - prev_pos) * (spec.damping / spec.dt)
    # the yield predicate is evaluated for every scene (the reference's
    # backward gate recomputes it); the ref angle moves only on plastic
    # scenes
    new_ref, yield_gate = update_ref_angle_gate(spec, new_pos,
                                                state.ref_angle)
    ref_angle = new_ref if spec.plastic else state.ref_angle
    new_state = SimState(pos=new_pos, vel=new_vel, ref_angle=ref_angle,
                         proj_flag=proj_flag, proj_dir=proj_dir, gripper=gs)
    aux = StepAux(prev_pos=prev_pos, contact_active=contact.active,
                  newton_pos=new_pos, yield_gate=yield_gate, contact=contact)
    return new_state, aux


def replay_step(spec: SceneSpec, params: Params, buffers, t: int, action,
                vel0, stats=None):
    """Step t+1 of a recorded tape (the `simulate(save_contacts=True)`
    buffers, of this package or carried from the JAX package) from the
    tape's own state at t: its gripper moved by `action`, Newton minimising
    with the contact set the recorded step used. The velocity at t is
    `vel0` for t = 0 and is rebuilt from the tape's positions otherwise.
    Returns the Newton positions; the recording holds its own as
    buffers["pos"][t + 1]. `stats` collects the solver counts (see
    solver.newton_solve)."""
    def grip(i):
        return GripperState(pos=buffers["gripper_pos"][i],
                            rot=buffers["gripper_rot"][i],
                            dist=buffers["gripper_dist"][i],
                            pad_local=buffers["pad_local"][i])

    pos_t = buffers["pos"][t]
    vel = vel0
    if t > 0:
        prev = gripper.write_bound_vertices(spec, buffers["pos"][t - 1],
                                            grip(t))
        vel = (pos_t - prev) * (spec.damping / spec.dt)
    delta_pos, delta_rot, delta_dis = (
        torch.as_tensor(a, dtype=spec.dtype, device=pos_t.device)
        for a in action)
    gs = gripper.gripper_step(spec, grip(t), delta_pos, delta_rot,
                              delta_dis)
    pos = gripper.write_bound_vertices(spec, pos_t, gs)
    c = buffers["contact"]
    contact = ContactSet(**{f.name: getattr(c, f.name)[t]
                            for f in dataclasses.fields(ContactSet)})
    return solver.newton_solve(spec, params, pos, pos, vel,
                               buffers["ref_angle"][t], contact, stats=stats)


def rollout(spec: SceneSpec, params: Params, state: SimState, actions,
            stats=None, save_contacts: bool = False):
    """Step through a trajectory. actions: (T, G, 3) / (T, G, 3) / (T, G).
    Returns (final_state, saved) with saved the per-step tuples (pos,
    ref_angle, gripper pos, rot, dist, pad_local, yield_gate), plus the
    step's ContactSet with save_contacts (the set the forward minimised
    with, which the backward then differentiates instead of rebuilding
    it)."""
    if spec.dev is None:
        raise TypeError("move the scene to a device first: spec.to(device)")
    saved = []
    for t in range(actions[0].shape[0]):
        state, aux = time_step(spec, params, state,
                               tuple(a[t] for a in actions), stats=stats)
        g = state.gripper
        step = (state.pos, state.ref_angle, g.pos, g.rot, g.dist,
                g.pad_local, aux.yield_gate)
        saved.append(step + (aux.contact,) if save_contacts else step)
    return state, saved


def simulate(spec: SceneSpec, params: Params, state0: SimState, actions,
             stats=None, save_contacts: bool = False):
    """Run a rollout and return (final_state, buffers) with buffers[t] the
    state after step t (buffers[0] = initial), the reference's trajectory
    tape layout. `stats` (a dict) collects solver counts (see
    solver.newton_solve). save_contacts adds buffers["contact"], the
    per-step ContactSets stacked (index t-1 is the set step t used)."""
    final, saved = rollout(spec, params, state0, actions, stats=stats,
                           save_contacts=save_contacts)
    return final, _assemble_buffers(state0, final, saved, save_contacts)


def simulate_chunked(spec: SceneSpec, params: Params, state0: SimState,
                     actions, chunk: int, stats=None,
                     save_contacts: bool = False):
    """simulate() under the JAX package's chunked signature. The JAX
    package runs its rollout in host-stitched segments of `chunk` steps, a
    workaround for its TPU worker's long scans; the port's rollout is a
    host loop already, so this is simulate() itself, bit-equal to it."""
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    return simulate(spec, params, state0, actions, stats=stats,
                    save_contacts=save_contacts)


def _assemble_buffers(state0: SimState, final: SimState, saved,
                      save_contacts: bool = False):
    cols = list(zip(*saved))

    def prepend(x0, xs):
        return torch.stack([x0, *xs])

    buffers = {
        "pos": prepend(state0.pos, cols[0]),
        "ref_angle": prepend(state0.ref_angle, cols[1]),
        "gripper_pos": prepend(state0.gripper.pos, cols[2]),
        "gripper_rot": prepend(state0.gripper.rot, cols[3]),
        "gripper_dist": prepend(state0.gripper.dist, cols[4]),
        "pad_local": prepend(state0.gripper.pad_local, cols[5]),
        # forward yield decisions at step t; index [t] aligns with the
        # backward's step t
        "yield_gate": prepend(torch.zeros_like(cols[6][0]), cols[6]),
        "final_proj_flag": final.proj_flag,
        "final_proj_dir": final.proj_dir,
    }
    if save_contacts:
        buffers["contact"] = ContactSet(**{
            f.name: torch.stack([getattr(c, f.name) for c in cols[7]])
            for f in dataclasses.fields(ContactSet)})
    return buffers
