"""Cloth initial-position generators (host-side numpy; counterpart of
`thinshelllab_tpu/scenes/cloth_init.py`, reference model_fold_offset.py
init_pos_offset:826-838)."""
from __future__ import annotations

import numpy as np


def grid_flat(N, M, dx, ox, oy, oz):
    i, j = np.meshgrid(np.arange(N + 1), np.arange(M + 1), indexing="ij")
    pos = np.stack([i * dx + ox, j * dx + oy, np.full_like(i, oz, float)], -1)
    return pos.reshape(-1, 3).astype(np.float64)
