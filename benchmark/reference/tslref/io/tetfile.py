"""TetGen-format .node/.ele/.face parsers, the cloth PLY writer, the
GelSight capture readers and the reward-curve score (counterpart of
`thinshelllab_tpu/io/tetfile.py`; reference engine/readfile.py).

The mesh files of the tactile pad (`tactile.node/.ele/.face`) and of the
balancing scenes' ball (`ball.node/.ele/.face`), the renderer's texture
options and asset pack are kept in this package's own `data/` directory.
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


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else x


def save_cloth_mesh_ply(pos: np.ndarray, faces: np.ndarray, path: str):
    """Minimal ASCII PLY writer (replaces the reference's open3d dependency,
    engine/readfile.py:117-128). pos and faces: numpy arrays or tensors
    (a device tensor is copied to the host)."""
    pos = np.asarray(_host(pos), dtype=np.float64)
    faces = np.asarray(_host(faces), dtype=np.int64)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pos)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for p in pos:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def read_gelsight_force(filename: str):
    """GelSight capture force series (reference readfile.read_force:79-90;
    requires h5py)."""
    import h5py

    with h5py.File(filename, "r") as f:
        force = np.array(f["force_measure"])
    force[:, 2] -= 0.44
    return force


def read_gelsight_pose(filename: str):
    """GelSight capture tool poses (reference readfile.read_pos:92-102)."""
    import h5py

    with h5py.File(filename, "r") as f:
        return np.array(f["tool_pose"])


def get_score(path: str, step: int, cmaes: bool = False):
    """Best reward over the first `step` entries of a plot_data.npy
    (reference readfile.get_score:130-135)."""
    rewards = np.load(path)[:step]
    if cmaes:
        rewards = -rewards - 5.1
    return rewards.max()
