"""Cloth initial-position generators (host-side numpy; counterpart of
`thinshelllab_tpu/scenes/cloth_init.py`, reference model_fold_offset.py
init_pos_offset:826-838, init_pos_offset_fold:841-868,
init_ref_angle_bridge:812-822)."""
from __future__ import annotations

import numpy as np

PI_REF = 3.1415  # the reference's truncated pi


def grid_flat(N, M, dx, ox, oy, oz):
    i, j = np.meshgrid(np.arange(N + 1), np.arange(M + 1), indexing="ij")
    pos = np.stack([i * dx + ox, j * dx + oy, np.full_like(i, oz, float)], -1)
    return pos.reshape(-1, 3).astype(np.float64)


def grid_fold(N, M, dx, ox, oy, oz, half_curv_num):
    """Pre-curled sheet: rows <= L folded back on top at height 2r, a
    semicircular curl between, flat from row R on."""
    r = dx if half_curv_num == 2 else dx * (half_curv_num * 2 - 1) / PI_REF
    L = 7 - half_curv_num + 1
    R = 7 + half_curv_num
    pos = np.zeros(((N + 1) * (M + 1), 3))
    for i in range(N + 1):
        for j in range(M + 1):
            k = i * (M + 1) + j
            if i <= L:
                pos[k] = ((15 - i) * dx + ox, j * dx + oy, oz + 2 * r)
            elif i <= R - 1:
                x = (15 - L) * dx
                ang = (i - L) / (half_curv_num * 2 - 1) * PI_REF
                pos[k] = (
                    x - r * np.sin(ang) + ox,
                    j * dx + oy,
                    oz + r * (1 + np.cos(ang)),
                )
            else:
                pos[k] = (i * dx + ox, j * dx + oy, oz)
    return pos


def fold_radius(dx, half_curv_num=2):
    return dx * (half_curv_num * 2 - 1) / PI_REF


def ref_angle_bridge(mesh, M, value=1.7):
    """Plastic arch pre-set (reference init_ref_angle_bridge :812-822):
    hinges whose v0 is in row 4 & v3 in row 6, or rows 9 & 11."""
    ref = np.zeros(mesh.NF * 3)
    for i in range(mesh.NF):
        for l_ in range(3):
            if mesh.counter_face[i, l_] > i:
                p = mesh.f2v[mesh.counter_face[i, l_], mesh.counter_point[i, l_]]
                v0 = mesh.f2v[i, l_]
                if v0 // (M + 1) == 4 and p // (M + 1) == 6:
                    ref[i * 3 + l_] = value
                if v0 // (M + 1) == 9 and p // (M + 1) == 11:
                    ref[i * 3 + l_] = value
    return ref
