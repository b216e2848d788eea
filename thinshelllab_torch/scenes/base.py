"""TaskScene: a built scene plus its task definition, and the hinge-row
mask of the folding and pick rewards (counterpart of
`thinshelllab_tpu/scenes/base.py`: `TaskScene` and `hinge_row_mask`)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.spec import Params, SceneSpec, SimState


def resolve_device(device=None, caller="thinshelllab_torch"):
    """`device`, or the CUDA card when it is None; no card raises: the CPU
    is taken only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA card; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")


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

    def to(self, device=None, dtype=None):
        """(spec, state0, params) moved to `device` in one call. The default
        is the CUDA card, and no card raises: the CPU is taken only when the
        caller asks for it (`to("cpu")`)."""
        device = resolve_device(device, "TaskScene.to")
        dtype = self.spec.dtype if dtype is None else dtype
        return (self.spec.to(device, dtype), self.state0.to(device, dtype),
                self.params.to(device, dtype))


def with_pre_curl_ref_angle(spec, state0):
    """state0 with the plastic rest angles its pre-curled cloth yields at
    build (init_fold -> init_ref_angle, model_fold_offset.py:1053-1057),
    computed in the scene's dtype from the builder's arrays, as the JAX
    package does."""
    from ..engine.stepper import update_ref_angle

    ref0 = update_ref_angle(spec.replace(cloth=spec.cloth.to("cpu",
                                                             spec.dtype)),
                            torch.as_tensor(state0.pos),
                            torch.as_tensor(state0.ref_angle))
    return state0.replace(ref_angle=ref0.numpy())


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
