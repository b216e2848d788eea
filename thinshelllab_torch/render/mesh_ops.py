"""Numpy mesh utilities for rendering and export (counterpart of
`thinshelllab_tpu/render/mesh_ops.py`; no trimesh dependency).

Covers the reference's convert_piece.py: giving the zero-thickness simulated
sheet a solid volume (offset both sides along vertex normals + flank faces
around the boundary loop) and subdividing for smooth shading, plus minimal
OBJ export without material statements (build_luisa_script.export_without_mtl).
"""
from __future__ import annotations

import numpy as np


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    n = np.zeros_like(verts)
    fn = np.cross(
        verts[faces[:, 1]] - verts[faces[:, 0]],
        verts[faces[:, 2]] - verts[faces[:, 0]],
    )
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return n / np.maximum(ln, 1e-300)


def boundary_loop_edges(faces: np.ndarray):
    """Edges referenced by exactly one face, as (E, 2) oriented pairs."""
    edges = {}
    for f in faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            key = (min(a, b), max(a, b))
            if key in edges:
                edges.pop(key)
            else:
                edges[key] = (a, b)
    return np.array(list(edges.values()), np.int64).reshape(-1, 2)


def thicken_cloth(verts: np.ndarray, faces: np.ndarray, thickness: float,
                  both_sides: bool = True):
    """Offset the sheet along vertex normals into a closed solid
    (reference convert_piece.thick_cloth:69)."""
    n = vertex_normals(verts, faces)
    h = thickness * (0.5 if both_sides else 1.0)
    top = verts + n * h
    bottom = verts - n * h if both_sides else verts.copy()
    nv = len(verts)
    new_verts = np.concatenate([top, bottom])
    top_faces = faces
    bottom_faces = faces[:, ::-1] + nv
    flank = []
    for a, b in boundary_loop_edges(faces):
        flank.append([a, b + nv, b])
        flank.append([a, a + nv, b + nv])
    flank = np.array(flank, np.int64).reshape(-1, 3)
    new_faces = np.concatenate([top_faces, bottom_faces, flank])
    return new_verts, new_faces


def subdivide(verts: np.ndarray, faces: np.ndarray):
    """One round of midpoint (1-to-4) subdivision (stands in for the
    reference's trimesh loop subdivision, convert_piece.subdivide_cloth)."""
    edge_mid = {}
    new_verts = [v for v in verts]

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            edge_mid[key] = len(new_verts)
            new_verts.append(0.5 * (verts[a] + verts[b]))
        return edge_mid[key]

    new_faces = []
    for f in faces:
        a, b, c = int(f[0]), int(f[1]), int(f[2])
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    return np.array(new_verts), np.array(new_faces, np.int64)


def export_obj(path: str, verts: np.ndarray, faces: np.ndarray,
               uv: np.ndarray | None = None):
    """Minimal OBJ writer without usemtl/mtllib statements."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if uv is not None:
            for t in uv:
                f.write(f"vt {t[0]} {t[1]}\n")
            for tri in faces:
                f.write(
                    f"f {tri[0]+1}/{tri[0]+1} {tri[1]+1}/{tri[1]+1} "
                    f"{tri[2]+1}/{tri[2]+1}\n"
                )
        else:
            for tri in faces:
                f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")


def process_cloth(verts, faces, thickness, subdivisions=1, uv=None):
    """Thicken + subdivide (reference convert_piece.process_cloth:246)."""
    v, f = thicken_cloth(verts, faces, thickness)
    for _ in range(subdivisions):
        v, f = subdivide(v, f)
    return v, f
