"""TaskScene: a built scene plus its task definition (rewards, adjoint
loss seeds), the pre-curled rest angles and the hinge-row mask of the
folding reward."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.spec import Params, SceneSpec, SimState


@dataclasses.dataclass
class TaskScene:
    name: str
    spec: SceneSpec
    state0: SimState
    params: Params
    n_part: int
    # reward(name) -> fn(buffers) -> scalar; 'default' is the task reward
    rewards: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    # seed_loss(buffers) -> (pos_grad (T,NV,3), angleref_grad (T,NH))
    seed_loss: Optional[Callable] = None
    seed_losses: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    sys_param: Optional[str] = None
    max_moving_dist: float = 0.001
    builder: object = None

    def reward(self, buffers, name: str = "default"):
        return self.rewards[name](buffers)

    def seed_for(self, name: str = "default"):
        return self.seed_losses.get(name, self.seed_loss)


def with_pre_curl_ref_angle(spec, state0):
    """state0 with the plastic rest angles its pre-curled cloth yields at
    build (init_fold -> init_ref_angle, model_fold_offset.py:1053-1057):
    where a hinge's angle lies more than k_angle from its rest angle, the
    rest angle moves to the yield surface. In float64, from the builder's
    arrays."""
    c = spec.cloth
    mask = np.asarray(c.hinge_mask, bool)
    x = np.asarray(state0.pos, np.float64)[np.asarray(c.hinge_verts)]
    sel = np.argmax(np.asarray(c.hinge_sel), axis=-1)
    pick = np.take_along_axis(x, sel[..., None], axis=1)
    n1 = np.cross(x[:, 1] - x[:, 0], x[:, 2] - x[:, 1])
    n2 = np.cross(pick[:, 0] - x[:, 3], pick[:, 1] - pick[:, 0])
    e = pick[:, 3] - pick[:, 2]
    with np.errstate(invalid="ignore", divide="ignore"):
        e = e / np.linalg.norm(e, axis=-1, keepdims=True)
        theta = np.arctan2(np.sum(np.cross(n1, n2) * e, -1),
                           np.sum(n1 * n2, -1))
    ref = np.asarray(state0.ref_angle, np.float64)
    k = np.asarray(c.k_angle, np.float64)[np.asarray(c.hinge_cloth)]
    d = np.where(mask, theta - ref, 0.0)
    moved = np.where(np.abs(d) > k, (np.abs(d) - k) * np.sign(d), 0.0)
    return state0.replace(ref_angle=ref + moved)


def like(a, ref):
    """`a` (a host array or list) as a tensor with `ref`'s dtype and
    device: the scenes' masks and targets meet the buffers this way."""
    return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)


def hinge_row_mask(builder, cloth_body, row_v0, row_v3):
    """Mask over the hinge soup selecting hinges whose v0 lies in grid row
    `row_v0` and whose v3 lies in row `row_v3` of the given cloth (the
    folding reward; reference Scene_folding.compute_reward:130-147)."""
    m = builder.bodies[cloth_body].cloth_mesh
    Mp1 = m.M + 1
    mask = np.zeros(m.NF * 3, bool)
    for i in range(m.NF):
        for l_ in range(3):
            if m.counter_face[i, l_] > i:
                v0 = m.f2v[i, l_]
                v3 = m.f2v[m.counter_face[i, l_], m.counter_point[i, l_]]
                if v0 // Mp1 == row_v0 and v3 // Mp1 == row_v3:
                    mask[i * 3 + l_] = True
    return mask
