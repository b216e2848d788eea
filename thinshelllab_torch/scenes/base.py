"""TaskScene: a built scene plus its task definition (counterpart of the
`TaskScene` dataclass of `thinshelllab_tpu/scenes/base.py`)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

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

    def to(self, device=None, dtype=None):
        """(spec, state0, params) moved to `device` in one call. The default
        is the CUDA card, and no card raises: the CPU is taken only when the
        caller asks for it (`to("cpu")`)."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("TaskScene.to: no CUDA card; pass "
                                   "device='cpu' to run on the CPU")
            device = torch.device("cuda")
        dtype = self.spec.dtype if dtype is None else dtype
        return (self.spec.to(device, dtype), self.state0.to(device, dtype),
                self.params.to(device, dtype))
