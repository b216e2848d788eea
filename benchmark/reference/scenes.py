"""A configuration's scene built with the frozen copy (`tslref`): the same
factory, keyword arguments and dtype as the program's, and the same
inputs from the seed."""
from __future__ import annotations

import importlib

import torch


DTYPES = {"float32": torch.float32, "float64": torch.float64}


def make(cfg, dtype=None):
    """The TaskScene of configuration `cfg` (a configs/*.json object) from
    tslref.scenes.<cfg["module"]>, in `dtype` (default the config's)."""
    mod = importlib.import_module(
        f"benchmark.reference.tslref.scenes.{cfg['module']}")
    kw = dict(cfg.get("kwargs", {}))
    kw["dtype"] = DTYPES[dtype or cfg["dtype"]]
    sc = mod.make(**kw)
    if "max_moving_dist" in cfg:
        sc.max_moving_dist = cfg["max_moving_dist"]
    return sc
