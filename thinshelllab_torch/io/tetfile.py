"""TetGen-format .node/.ele/.face parsers (counterpart of
`thinshelllab_tpu/io/tetfile.py`).

The mesh files of the tactile pad (`tactile.node/.ele/.face`) and of the
balancing scenes' ball (`ball.node/.ele/.face`) are kept in this package's
own `data/` directory.
"""
from __future__ import annotations

import os

import numpy as np

_DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def data_path(name: str) -> str:
    return os.path.join(_DATA_DIR, name)


def _read_rows(filename: str, ncols: int, dtype):
    with open(filename, "r", encoding="utf-8") as f:
        count = int(f.readline().split()[0])
        rows = np.empty((count, ncols), dtype=dtype)
        for i in range(count):
            parts = f.readline().split()
            rows[i] = [dtype(p) for p in parts[1 : 1 + ncols]]
    return count, rows


def read_node(filename: str):
    """Returns (n_verts, (n_verts, 3) float64 positions)."""
    return _read_rows(filename, 3, np.float64)


def read_ele(filename: str):
    """Returns (n_cells, (n_cells, 4) int32 tet vertex indices)."""
    count, rows = _read_rows(filename, 4, np.int64)
    return count, rows.astype(np.int32)


def read_smesh(filename: str):
    """Returns (n_faces, (n_faces, 3) int32 surface triangles)."""
    count, rows = _read_rows(filename, 3, np.int64)
    return count, rows.astype(np.int32)
