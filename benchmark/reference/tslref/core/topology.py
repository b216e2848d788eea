"""Host-side mesh topology builders (counterpart of
`thinshelllab_tpu/core/topology.py`): the reference's cloth grid with its
verbatim hinge table, the 5-tet cube lattice and the TetGen tactile pad.

The cloth tables and the cube lattice come from the native C++ helper
(`thinshelllab_torch/native`, built with g++ at first use), as in the JAX
package; TSL_NO_NATIVE=1 takes the numpy versions (`cloth_tables_numpy`,
`cube_tets_numpy`), which compute the same integers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .. import native
from ..io import tetfile


@dataclasses.dataclass
class ClothMesh:
    N: int
    M: int
    NV: int
    NF: int
    f2v: np.ndarray            # (NF, 3) int32 local vertex ids
    counter_face: np.ndarray   # (NF, 3) int32 local face ids (or -1 / stale 0)
    counter_point: np.ndarray  # (NF, 3) int32
    hinge_mask: np.ndarray     # (NF, 3) bool: counter_face[i][l] > i
    indices: np.ndarray        # (NF*3,) render triangle list
    uv: np.ndarray             # (NV, 2)


def build_cloth_mesh(N: int, M: int, exact_adjacency: bool = False) -> ClothMesh:
    """Regular (N x M) quad grid split checkerboard-style, with the
    reference's hinge adjacency table replicated verbatim, zero-init and
    slot-overwrite quirks included (the set of active hinges defines the
    bending energy). exact_adjacency=True replaces the table with the
    complete half-edge adjacency (`_exact_adjacency`)."""
    NV = (N + 1) * (M + 1)
    NF = 2 * N * M
    tables = None if exact_adjacency else native.cloth_mesh_tables(N, M)
    f2v, cf, cp, indices = tables or cloth_tables_numpy(N, M)
    if exact_adjacency:
        cf, cp = _exact_adjacency(f2v, NF)
    uv = np.zeros((NV, 2))
    ii, jj = np.meshgrid(np.arange(N + 1), np.arange(M + 1), indexing="ij")
    uv[:, 0] = (1.0 - jj / M).ravel()
    uv[:, 1] = (ii / N).ravel()
    hinge_mask = cf > np.arange(NF)[:, None]
    return ClothMesh(N, M, NV, NF, f2v, cf, cp, hinge_mask, indices, uv)


def cloth_tables_numpy(N: int, M: int):
    """(f2v, counter_face, counter_point, indices) of the N x M grid, the
    numpy version of native.cloth_mesh_tables."""
    NF = 2 * N * M
    f2v = np.zeros((NF, 3), dtype=np.int32)
    # Taichi zero-initialises fields; the reference relies on that for
    # slots it never writes (odd-quad slot 0), so start at 0, not -1
    cf = np.zeros((NF, 3), dtype=np.int32)
    cp = np.zeros((NF, 3), dtype=np.int32)
    indices = np.zeros(NF * 3, dtype=np.int32)

    for i in range(N):
        for j in range(M):
            k = (i * M + j) * 2
            a = i * (M + 1) + j
            b = a + 1
            c = a + M + 2
            d = a + M + 1
            if (i + j) % 2 == 0:
                f2v[k] = (c, b, a)
                f2v[k + 1] = (a, d, c)
                cf[k, 0], cp[k, 0] = (((i - 1) * M + j) * 2 + 1, 2) if i > 0 else (-1, 0)
                cf[k, 2], cp[k, 2] = (k + 2, 0) if j < M - 1 else (-1, 0)
                cf[k + 1, 0], cp[k + 1, 0] = (
                    (((i + 1) * M + j) * 2, 2) if i < N - 1 else (-1, 0)
                )
                cf[k + 1, 2], cp[k + 1, 2] = (k - 2, 0) if j > 0 else (-1, 0)
                quad_tris = (a, c, b, d, c, a)
            else:
                f2v[k] = (b, a, d)
                f2v[k + 1] = (d, c, b)
                # the reference writes slot 2 for the i>0 neighbour and then
                # overwrites the same slot for the j>0 neighbour
                if i > 0:
                    cf[k, 2], cp[k, 2] = ((i - 1) * M + j) * 2 + 1, 0
                else:
                    cf[k, 2] = -1
                cf[k + 1, 0], cp[k + 1, 0] = (k + 3, 2) if j < M - 1 else (-1, 0)
                if i < N - 1:
                    cf[k + 1, 2], cp[k + 1, 2] = ((i + 1) * M + j) * 2, 0
                else:
                    cf[k + 1, 2] = -1
                if j > 0:
                    cf[k, 2], cp[k, 2] = k - 2, 2
                else:
                    cf[k, 2] = -1
                quad_tris = (b, a, d, d, c, b)
            cf[k, 1], cp[k, 1] = k + 1, 1
            cf[k + 1, 1], cp[k + 1, 1] = k, 1
            qid = i * M + j
            indices[qid * 6 : qid * 6 + 6] = quad_tris
    return f2v, cf, cp, indices


def _exact_adjacency(f2v: np.ndarray, NF: int):
    """Complete half-edge adjacency: counter_face[i][l] is the other face
    sharing the edge opposite local vertex l; counter_point its far vertex."""
    cf = -np.ones((NF, 3), dtype=np.int32)
    cp = np.zeros((NF, 3), dtype=np.int32)
    edge_map: dict[tuple[int, int], tuple[int, int]] = {}
    for i in range(NF):
        for l in range(3):
            u, v = f2v[i, (l + 1) % 3], f2v[i, (l + 2) % 3]
            key = (min(u, v), max(u, v))
            if key in edge_map:
                j, m = edge_map.pop(key)
                cf[i, l], cp[i, l] = j, m
                cf[j, m], cp[j, m] = i, l
            else:
                edge_map[key] = (i, l)
    return cf, cp


@dataclasses.dataclass
class TetMesh:
    n_verts: int
    n_cells: int
    n_surfaces: int
    rest_pos: np.ndarray  # (n_verts, 3) float64
    tets: np.ndarray      # (n_cells, 4) int32
    surfaces: np.ndarray  # (n_surfaces, 3) int32, outward-oriented


def build_cube_tet_mesh(nx: int, ny: int, nz: int, length: float) -> TetMesh:
    """5-tet decomposition per lattice cell plus boundary-surface
    extraction (reference model_elastic_offset.py:285-376)."""
    n_cube = np.array([nx, ny, nz])
    dx = length / (n_cube.max() - 1)
    n_verts = nx * ny * nz
    gx, gy, gz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    rest = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float64) * dx

    tets = native.cube_tets(nx, ny, nz)
    if tets is None:
        tets = cube_tets_numpy(nx, ny, nz)
    surfaces = _extract_cube_surface(tets, rest, n_cube)
    return TetMesh(n_verts, len(tets), len(surfaces), rest, tets, surfaces)


def cube_tets_numpy(nx: int, ny: int, nz: int) -> np.ndarray:
    """The lattice's 5 tets a cell (the numpy version of
    native.cube_tets)."""
    def i2p(ix, iy, iz):
        return (ix * ny + iy) * nz + iz

    tets = []
    corner_sets = [(j, j ^ 1, j ^ 2, j ^ 4) for j in (0, 3, 5, 6)] + [(1, 2, 4, 7)]
    for ix in range(nx - 1):
        for iy in range(ny - 1):
            for iz in range(nz - 1):
                parity = np.array([ix, iy, iz]) & 1
                for corners in corner_sets:
                    tet = []
                    for v in corners:
                        bits = np.array([(v >> 0) & 1, (v >> 1) & 1, (v >> 2) & 1])
                        off = (bits ^ parity) & 1
                        tet.append(i2p(ix + off[0], iy + off[1], iz + off[2]))
                    tets.append(tet)
    return np.array(tets, dtype=np.int32).reshape(-1, 4)


def _boundary_code(u: int, n_cube: np.ndarray) -> int:
    """Bitmask of the lattice boundaries vertex u lies on (reference
    model_elastic_offset.check:333-344; peels z, then y, then x)."""
    ans = 0
    rest = u
    for i in range(3):
        k = rest % n_cube[2 - i]
        rest = rest // n_cube[2 - i]
        if k == 0:
            ans |= 1 << (i * 2)
        if k == n_cube[2 - i] - 1:
            ans |= 1 << (i * 2 + 1)
    return ans


def _extract_cube_surface(tets, rest, n_cube):
    codes = np.array([_boundary_code(u, n_cube) for u in range(len(rest))])
    faces = []
    for c in range(len(tets)):
        if c % 5 == 4:
            continue
        for i in (0, 2, 3):
            verts = [int(tets[c][(i + j) % 4]) for j in range(3)]
            if codes[verts[0]] & codes[verts[1]] & codes[verts[2]]:
                far = int(tets[c][(i + 3) % 4])
                normal = np.cross(
                    rest[verts[1]] - rest[verts[0]], rest[verts[2]] - rest[verts[0]]
                )
                if np.dot(normal, rest[far] - rest[verts[0]]) > 0:
                    verts[1], verts[2] = verts[2], verts[1]
                faces.append(verts)
    return np.array(faces, dtype=np.int32).reshape(-1, 3)


def load_tet_mesh(node: str, ele: str, face: str) -> TetMesh:
    n_verts, rest = tetfile.read_node(node)
    n_cells, tets = tetfile.read_ele(ele)
    n_faces, surfaces = tetfile.read_smesh(face)
    return TetMesh(n_verts, n_cells, n_faces, rest, tets, surfaces)


def load_ball_mesh() -> TetMesh:
    """The soft ball of the balancing scenes (reference ball.node/.ele/.face,
    loaded by Scene_balancing)."""
    return load_tet_mesh(
        tetfile.data_path("ball.node"),
        tetfile.data_path("ball.ele"),
        tetfile.data_path("ball.face"),
    )


@dataclasses.dataclass
class TactileMesh(TetMesh):
    is_surface: np.ndarray     # (n_verts,) bool
    is_bottom: np.ndarray      # surface & rest_z < 0.001
    is_inner: np.ndarray       # surface & |rest| < 0.0076
    is_outer_surf: np.ndarray  # surface & |rest| > 0.0148
    frozen_cnt: int
    surf_point: int
    bound_idx: np.ndarray      # (frozen_cnt,) local ids, ascending
    surface_idx: np.ndarray    # (surf_point,) local ids


def load_tactile_mesh() -> TactileMesh:
    """The tactile pad with its surface classification (reference
    model_elastic_tactile.py:302-326)."""
    m = load_tet_mesh(
        tetfile.data_path("tactile.node"),
        tetfile.data_path("tactile.ele"),
        tetfile.data_path("tactile.face"),
    )
    is_surface = np.zeros(m.n_verts, dtype=bool)
    is_surface[m.surfaces.ravel()] = True
    r = np.linalg.norm(m.rest_pos, axis=1)
    is_bottom = is_surface & (m.rest_pos[:, 2] < 0.001)
    is_inner = is_surface & (r < 0.0076)
    is_outer = is_surface & (r > 0.0148)
    frozen = is_bottom | is_inner
    surf_only = is_surface & ~frozen & is_outer
    return TactileMesh(
        n_verts=m.n_verts,
        n_cells=m.n_cells,
        n_surfaces=m.n_surfaces,
        rest_pos=m.rest_pos,
        tets=m.tets,
        surfaces=m.surfaces,
        is_surface=is_surface,
        is_bottom=is_bottom,
        is_inner=is_inner,
        is_outer_surf=is_outer,
        frozen_cnt=int(frozen.sum()),
        surf_point=int(surf_only.sum()),
        bound_idx=np.nonzero(frozen)[0].astype(np.int32),
        surface_idx=np.nonzero(surf_only)[0].astype(np.int32),
    )


def orient_surface_outward(surfaces, pos, inner_point, invert_mask=None):
    """Flip triangles whose normal points toward `inner_point`;
    `invert_mask` marks faces whose test is inverted (tactile inner-circle
    faces)."""
    surfaces = surfaces.copy()
    p1 = pos[surfaces[:, 0]]
    n = np.cross(pos[surfaces[:, 1]] - p1, pos[surfaces[:, 2]] - p1)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
    inward = np.einsum("ij,ij->i", n, inner_point[None, :] - p1) > 0
    flip = inward if invert_mask is None else (inward ^ invert_mask)
    surfaces[flip, 1], surfaces[flip, 2] = surfaces[flip, 2], surfaces[flip, 1]
    return surfaces
