"""TaskScene: a built scene plus its task definition (counterpart of the
`TaskScene` dataclass of `thinshelllab_tpu/scenes/base.py`)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

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

    def to(self, device, dtype=None):
        """(spec, state0, params) moved to `device` in one call."""
        dtype = self.spec.dtype if dtype is None else dtype
        return (self.spec.to(device, dtype), self.state0.to(device, dtype),
                self.params.to(device, dtype))
