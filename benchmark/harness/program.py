"""The system under test: thinshelllab_torch, reached through its normal
entry points (scenes.registry, the drivers of train/)."""
from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the control of a configuration: the program's own path one precision down
CONTROL_DTYPE = {"float64": "float32"}


def make_scene(cfg, dtype):
    """The TaskScene of configuration `cfg` from the port's registry, in
    `dtype` (a name of DTYPES)."""
    from thinshelllab_torch.scenes import registry

    kw = dict(cfg.get("kwargs", {}))
    kw["dtype"] = DTYPES[dtype]
    sc = registry.make_scene(cfg["scene"], **kw)
    if "max_moving_dist" in cfg:
        sc.max_moving_dist = cfg["max_moving_dist"]
    return sc
