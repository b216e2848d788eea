"""The guard against JAX: the benchmark measures thinshelllab_torch, and no
run may hold jax, jaxlib, flax or the JAX package. Modules are compared by
their top-level name (the part before the first dot), whole: the port's
name begins with the JAX package's."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "thinshelllab_tpu")


def forbidden_modules(modules=None):
    """The sorted top-level names in `modules` (default sys.modules) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
