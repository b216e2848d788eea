"""Quaternion utilities, scalar-first (counterpart of
`thinshelllab_tpu/utils/quaternion.py`; reference gripper_tactile.py:150-218)."""
from __future__ import annotations

import torch


def quat_to_rotmat(q):
    """(..., 4) scalar-first quaternion -> (..., 3, 3) rotation matrix
    (un-normalised form, valid for unit quaternions)."""
    s, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            s * s + x * x - y * y - z * z,
            2 * (x * y - s * z),
            2 * (x * z + s * y),
            2 * (x * y + s * z),
            s * s - x * x + y * y - z * z,
            2 * (y * z - s * x),
            2 * (x * z - s * y),
            2 * (y * z + s * x),
            s * s - x * x - y * y + z * z,
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(m):
    """(..., 3, 3) -> (..., 4); assumes trace > -1 (as the reference does)."""
    s = torch.sqrt(1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]) / 2.0
    x = (m[..., 2, 1] - m[..., 1, 2]) / (4 * s)
    y = (m[..., 0, 2] - m[..., 2, 0]) / (4 * s)
    z = (m[..., 1, 0] - m[..., 0, 1]) / (4 * s)
    return torch.stack([s, x, y, z], dim=-1)


def quat_apply_delta_rot(q, delta_rot):
    """Reference rotation update (gripper_tactile.step_simple:178-190):
    q <- normalize(q + (-delta_rot . v, q_s delta_rot + delta_rot x v))."""
    v = q[..., 1:]
    real = -torch.sum(delta_rot * v, dim=-1)
    res = q[..., 0:1] * delta_rot + torch.linalg.cross(delta_rot, v, dim=-1)
    q_new = q + torch.cat([real[..., None], res], dim=-1)
    return q_new / torch.linalg.vector_norm(q_new, dim=-1, keepdim=True)
