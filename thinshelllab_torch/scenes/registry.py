"""Scene registry: string-keyed scene factories and reward resolution
(counterpart of `thinshelllab_tpu/scenes/registry.py`; reference
RL_env.py:53,198 and run_cmaes_all.py:46)."""
from __future__ import annotations

from typing import Callable, Dict

from . import (balancing, bench_scene, bouncing, card, folding, forming,
               interact, lifting, pick, sliding)

SCENES: Dict[str, Callable] = {
    "folding": folding.make,
    "lifting": lifting.make,
    "sliding": sliding.make,
    "separating": sliding.make,  # reference alias (silding/separating)
    "card": card.make,
    "pick": pick.make,
    "pick_fold": pick.make,
    "forming": forming.make,
    "balancing": balancing.make,
    "balance": balancing.make,
    "throwing": balancing.make,
    "bouncing": bouncing.make,
    "interact": interact.make,
    "bench": bench_scene.make,
}


def make_scene(name: str, **kwargs):
    if name not in SCENES:
        raise KeyError(f"unknown scene '{name}'; available: {sorted(SCENES)}")
    return SCENES[name](**kwargs)


def resolve_reward(scene, name: str | None):
    if not name or name == "default" or name == "compute_reward":
        return scene.rewards["default"]
    if name in scene.rewards:
        return scene.rewards[name]
    raise KeyError(f"scene '{scene.name}' has no reward '{name}'; "
                   f"available: {sorted(scene.rewards)}")
