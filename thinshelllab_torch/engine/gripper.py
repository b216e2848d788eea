"""Rigid effector kinematics as functions of GripperState (counterpart of
`thinshelllab_tpu/engine/gripper.py`; reference engine/gripper_tactile.py
and engine/gripper_single.py)."""
from __future__ import annotations

import torch

from ..core.spec import GripperState, SceneSpec
from ..utils.quaternion import quat_apply_delta_rot, quat_to_rotmat


def gripper_step(spec: SceneSpec, gs: GripperState, delta_pos, delta_rot,
                 delta_dis):
    """Apply a per-part action (reference step/step_simple:178-218)."""
    g = spec.gripper
    if g.mode == "none":
        return gs
    pos = gs.pos + delta_pos
    rot = quat_apply_delta_rot(gs.rot, delta_rot)
    dist = gs.dist
    pad_local = gs.pad_local
    if g.mode == "paired":
        dist = dist + delta_dis
        # open_gripper: upper pads +dz, lower pads -dz (reference :214-218)
        signs = torch.as_tensor(g.pad_sign, dtype=pos.dtype, device=pos.device)
        parts = torch.as_tensor(g.pad_part, device=pos.device)
        pad_local = pad_local.clone()
        pad_local[:, :, 2] += (signs * delta_dis[parts])[:, None]
    return GripperState(pos=pos, rot=rot, dist=dist, pad_local=pad_local)


def pad_world_positions(spec: SceneSpec, gs: GripperState):
    """(n_pads, n_pad_verts, 3) world coordinates of every pad vertex."""
    parts = torch.as_tensor(spec.gripper.pad_part, device=gs.pos.device)
    R = quat_to_rotmat(gs.rot)[parts]  # (n_pads, 3, 3)
    t = gs.pos[parts]                  # (n_pads, 3)
    return torch.einsum("pij,pvj->pvi", R, gs.pad_local) + t[:, None, :]


def write_bound_vertices(spec: SceneSpec, pos, gs: GripperState):
    """Write the rigid pose into the pads' frozen boundary vertices
    (reference update_bound:245-249). Returns a new tensor."""
    g = spec.gripper
    if g.mode == "none":
        return pos
    world = pad_world_positions(spec, gs)
    pos = pos.clone()
    for p in range(g.n_pads):
        pos[g.pad_offset[p] + g.bound_idx] = world[p, g.bound_idx]
    return pos
