"""Host-side (numpy) plans for the Hessian operator, built once per scene:
the hybrid DIA plan, the leftover pull slots and the static contact split.

These are the planner functions of `thinshelllab_tpu/engine/elements.py`
(same names); they run on the numpy spec the builder makes and never touch
a device. `engine.elements` re-exports them under their JAX-side names.
"""
from __future__ import annotations

import numpy as np

from ..core.spec import DiaPlan, HvpSlots


def static_block_count(spec) -> int:
    """Number of leading STATIC elements in the fused block array (membrane,
    bending, neo, tact -- in fuse_groups order); barrier+friction follow."""
    n = spec.cloth.f2v.shape[0] + spec.cloth.hinge_verts.shape[0]
    n += spec.neo.tets.shape[0] + spec.tact.tets.shape[0]
    return n


def _enumerate_static_slots(spec):
    """All static block slots as flat arrays (rows, e, ab, cols)."""
    groups = []  # (idx (E,k), base, k[, mask])
    base = 0
    f2v = np.asarray(spec.cloth.f2v)
    groups.append((f2v, base, 3))
    base += f2v.shape[0]
    hv = np.asarray(spec.cloth.hinge_verts)
    hm = np.asarray(spec.cloth.hinge_mask)
    groups.append((hv, base, 4, hm))
    base += hv.shape[0]
    for soup in (spec.neo, spec.tact):
        t = np.asarray(soup.tets)
        if t.shape[0]:
            groups.append((t, base, 4))
        base += t.shape[0]

    rows_all, e_all, ab_all, col_all = [], [], [], []
    for g in groups:
        idx, gbase, k = g[0], g[1], g[2]
        gmask = g[3] if len(g) > 3 else None
        E = idx.shape[0]
        if E == 0:
            continue
        e_ids = gbase + np.arange(E, dtype=np.int64)
        for a in range(k):
            for b in range(k):
                rows = idx[:, a].astype(np.int64)
                if gmask is not None:
                    rows_all.append(rows[gmask])
                    e_all.append(e_ids[gmask])
                    ab_all.append(np.full(gmask.sum(), a * 4 + b, np.int64))
                    col_all.append(idx[gmask, b].astype(np.int64))
                else:
                    rows_all.append(rows)
                    e_all.append(e_ids)
                    ab_all.append(np.full(E, a * 4 + b, np.int64))
                    col_all.append(idx[:, b].astype(np.int64))
    return (np.concatenate(rows_all), np.concatenate(e_all),
            np.concatenate(ab_all), np.concatenate(col_all))


def build_hvp_slots(spec, keep_mask=None):
    """HvpSlots for the static soups. Padding slots point at a membrane
    element's always-zero (3,3) pad block and column NV (the zero row of the
    padded x). keep_mask restricts to a subset of slots (the DIA leftover)."""
    NV = spec.NV
    rows, e_arr, ab_arr, col_arr = _enumerate_static_slots(spec)
    if keep_mask is not None:
        rows, e_arr, ab_arr, col_arr = (
            rows[keep_mask], e_arr[keep_mask], ab_arr[keep_mask],
            col_arr[keep_mask],
        )
    if len(rows) == 0:
        return HvpSlots(
            slot_e=np.zeros((0, 0), np.int32),
            slot_ab=np.zeros((0, 0), np.int32),
            slot_col=np.zeros((0, 0), np.int32),
            row_ids=np.zeros((0,), np.int32),
            D=0,
        )
    order = np.argsort(rows, kind="stable")
    rows, e_arr, ab_arr, col_arr = (
        rows[order], e_arr[order], ab_arr[order], col_arr[order]
    )
    counts = np.bincount(rows, minlength=NV)
    row_ids = np.nonzero(counts)[0].astype(np.int32)
    R = len(row_ids)
    D = int(counts.max())
    if spec.cloth.f2v.shape[0] == 0:
        raise ValueError("hvp slots need at least one cloth")
    slot_e = np.zeros((R, D), np.int32)
    slot_ab = np.full((R, D), 15, np.int32)  # (3,3) pad block
    slot_col = np.full((R, D), NV, np.int32)
    start = np.zeros(NV + 1, np.int64)
    np.cumsum(counts, out=start[1 : NV + 1])
    for ri, v in enumerate(row_ids):
        c = counts[v]
        s0 = start[v]
        slot_e[ri, :c] = e_arr[s0 : s0 + c]
        slot_ab[ri, :c] = ab_arr[s0 : s0 + c]
        slot_col[ri, :c] = col_arr[s0 : s0 + c]
    return HvpSlots(slot_e=slot_e, slot_ab=slot_ab, slot_col=slot_col,
                    row_ids=row_ids, D=D)


def _decompose_shift_candidates(rel: int, M: int):
    """All (di, dj) splits of a flat vertex shift rel on the (N+1, M+1)
    grid with dj in the stencil window [-3, 3]."""
    out = []
    for dj in range(-3, 4):
        if (rel - dj) % (M + 1) == 0:
            out.append(((rel - dj) // (M + 1), dj))
    return out


def _plan_cloth_stencils(spec):
    """Per-cloth stencil families: verify that every (parity, class, vertex
    slot) of the raster-ordered face/hinge soups sits at a constant shift
    from the cell origin, and emit slice-add families for assembly. Classes
    that fail verification go to the fallback lists."""
    c = spec.cloth
    NF_total = c.f2v.shape[0]
    f2v = np.asarray(c.f2v)
    hv = np.asarray(c.hinge_verts)
    hm = np.asarray(c.hinge_mask)

    cloths = []
    offsets = []

    def o_id(o):
        if o not in offsets:
            offsets.append(o)
        return offsets.index(o)

    mem_cov = np.zeros(NF_total, bool)
    hinge_cov = np.zeros(len(hm), bool)
    extra_ea, extra_rows = [], []

    for ci in range(c.n_cloths):
        N, M = c.N[ci], c.M[ci]
        v_off = c.offsets[ci]
        fb = c.face_offsets[ci]
        NFc = 2 * N * M
        f_g = f2v[fb : fb + NFc].reshape(N, M, 2, 3)
        h_g = hv[3 * fb : 3 * fb + 3 * NFc].reshape(N, M, 6, 4)
        hm_g = hm[3 * fb : 3 * fb + 3 * NFc].reshape(N, M, 6)
        ii, jj = np.meshgrid(np.arange(N), np.arange(M), indexing="ij")
        origin = v_off + ii * (M + 1) + jj
        par_g = (ii + jj) % 2

        fams, res_fams = [], []
        for kind, varr, n_cls, act, kk in (
            (0, f_g, 2, None, 3),
            (1, h_g, 6, hm_g, 4),
        ):
            for par in (0, 1):
                for cc in range(n_cls):
                    members = par_g == par
                    if act is not None:
                        members = members & act[:, :, cc]
                    if not members.any():
                        continue
                    rels, ok = [], True
                    for a in range(kk):
                        vals = (varr[:, :, cc, a] - origin)[members]
                        if not (vals == vals[0]).all():
                            ok = False
                            break
                        rels.append(int(vals[0]))
                    regions = []
                    if ok:
                        mi, mj = np.nonzero(members)
                        for a in range(kk):
                            found = None
                            for di, dj in _decompose_shift_candidates(rels[a], M):
                                i0, i1 = max(0, -di), min(N, N + 1 - di)
                                j0, j1 = max(0, -dj), min(M, M + 1 - dj)
                                if (
                                    i0 < i1 and j0 < j1
                                    and not (mi < i0).any()
                                    and not (mi >= i1).any()
                                    and not (mj < j0).any()
                                    and not (mj >= j1).any()
                                ):
                                    found = (i0, i1, j0, j1, di, dj)
                                    break
                            if found is None:
                                ok = False
                                break
                            regions.append(found)
                    if not ok:
                        # fallback: residual scatter + leftover pull blocks
                        mi, mj = np.nonzero(members)
                        if kind == 0:
                            e_gl = fb + (mi * M + mj) * 2 + cc
                            for a in range(kk):
                                extra_ea.extend((e_gl * 4 + a).tolist())
                                extra_rows.extend(f2v[e_gl, a].tolist())
                        else:
                            h_gl = 3 * fb + (mi * M + mj) * 6 + cc
                            e_gl = NF_total + h_gl
                            for a in range(kk):
                                extra_ea.extend((e_gl * 4 + a).tolist())
                                extra_rows.extend(hv[h_gl, a].tolist())
                        continue
                    mi, mj = np.nonzero(members)
                    if kind == 0:
                        mem_cov[fb + (mi * M + mj) * 2 + cc] = True
                    else:
                        hinge_cov[3 * fb + (mi * M + mj) * 6 + cc] = True
                    for a in range(kk):
                        i0, i1, j0, j1, di, dj = regions[a]
                        res_fams.append(
                            (kind, cc, a, i0, i1, j0, j1, di, dj, par))
                        for b in range(kk):
                            o = rels[b] - rels[a]
                            fams.append((kind, cc, a, b, o_id(o),
                                         i0, i1, j0, j1, di, dj, par))
        cloths.append((N, M, v_off, fb, NF_total + 3 * fb,
                       tuple(fams), tuple(res_fams)))
    return (tuple(cloths), offsets, mem_cov, hinge_cov,
            np.asarray(extra_ea, np.int64), np.asarray(extra_rows, np.int64))


def build_dia_plan(spec, min_count=64):
    """Hybrid DIA plan. Returns (DiaPlan|None, leftover_mask|None).

    Three tiers: cloth faces/hinges as 2D stencil slice-adds; lattice and
    tactile tet blocks on offsets carrying >= min_count blocks via a compact
    row gather + one-hot placement; everything else on the pull path
    (leftover mask over the _enumerate_static_slots order)."""
    NV = spec.NV
    if spec.cloth.f2v.shape[0] == 0:
        return None, None
    # the JAX package keeps grids narrower than 8 on the pull path; the
    # port follows it so both packages build the same plan
    if min(m + 1 for m in spec.cloth.M) < 8:
        return None, None
    (cloths, offsets, mem_cov, hinge_cov, extra_ea,
     extra_rows) = _plan_cloth_stencils(spec)
    if not offsets:
        return None, None

    ns = static_block_count(spec)
    NF_total = spec.cloth.f2v.shape[0]
    NH_total = spec.cloth.hinge_verts.shape[0]
    tet_base = NF_total + NH_total
    tets = []
    for soup in (spec.neo, spec.tact):
        t = np.asarray(soup.tets)
        if t.shape[0]:
            tets.append(t)
    neo_in = np.zeros((4, 4, np.asarray(spec.neo.tets).shape[0]), bool)
    tact_in = np.zeros((4, 4, np.asarray(spec.tact.tets).shape[0]), bool)
    if tets:
        tet_idx = np.concatenate(tets, axis=0)
        T = tet_idx.shape[0]
        off_all = (tet_idx[:, None, :] - tet_idx[:, :, None]).reshape(-1)
        uniq, counts = np.unique(off_all, return_counts=True)
        dense_t = set(int(o) for o in uniq[counts >= min_count])
        dense_t |= set(offsets)
        for o in sorted(dense_t):
            if o not in offsets:
                offsets.append(o)
        lane = {int(o): i for i, o in enumerate(offsets)}

        rows_all = np.unique(tet_idx.reshape(-1))
        Rn = len(rows_all)
        row_of = {int(v): i for i, v in enumerate(rows_all)}
        inc = [[] for _ in range(Rn)]
        for e_loc in range(T):
            e_gl = tet_base + e_loc
            for a in range(4):
                inc[row_of[int(tet_idx[e_loc, a])]].append(e_gl * 4 + a)
        Dr = max(len(x) for x in inc)
        sentinel = ns * 4
        row_tab = np.full((Rn, Dr), sentinel, np.int32)
        for r, lst in enumerate(inc):
            row_tab[r, : len(lst)] = lst
        n_off = len(offsets)
        o_idx = np.full((Rn, Dr, 4), n_off, np.int32)
        tet_in = np.zeros((T, 4, 4), bool)
        for r, lst in enumerate(inc):
            rv = int(rows_all[r])
            for d, ea in enumerate(lst):
                e_loc = ea // 4 - tet_base
                a = ea % 4
                for b in range(4):
                    o = int(tet_idx[e_loc, b]) - rv
                    if o in lane:
                        o_idx[r, d, b] = lane[o]
                        tet_in[e_loc, a, b] = True
        nT_neo = neo_in.shape[2]
        neo_in = np.transpose(tet_in[:nT_neo], (1, 2, 0))
        tact_in = np.transpose(tet_in[nT_neo:], (1, 2, 0))
        rows_arr = rows_all.astype(np.int32)
        o_idx = o_idx.reshape(Rn, Dr * 4)
    else:
        row_tab = np.zeros((0, 1), np.int32)
        o_idx = np.zeros((0, 4), np.int32)
        rows_arr = np.zeros((0,), np.int32)
        Dr = 1

    hm = np.asarray(spec.cloth.hinge_mask)
    parts = [
        np.concatenate([mem_cov for _ in range(9)]),
        np.concatenate([hinge_cov[hm] for _ in range(16)]),
        neo_in.reshape(-1),
        tact_in.reshape(-1),
    ]
    in_dia = np.concatenate([p for p in parts if p.size])
    if in_dia.size == 0:
        return None, None

    plan = DiaPlan(
        row_tab=row_tab,
        o_idx=o_idx,
        rows=rows_arr,
        extra_ea=extra_ea.astype(np.int32),
        extra_rows=extra_rows.astype(np.int32),
        offsets=tuple(int(o) for o in offsets),
        max_abs_off=int(max(abs(int(o)) for o in offsets)),
        Dr=Dr,
        NVp=-(-(NV + 1) // 1024) * 1024,
        cloths=cloths,
    )
    return plan, ~in_dia


def contact_static_split(spec, mm=True):
    """Static partition of the merged contact group's slots into
    frozen-source diagonal pairs, selection-matmul ('mm') pairs and general
    gather/scatter pairs. Returns (diag_ranges, mm_ranges, gen_ranges) with
    entries (cq_start, count, v_lo) / (cq_start, count, v_lo, f_vlo, f_vn) /
    (cq_start, count), or None when no pair qualifies for diag or mm.

    mm=False classifies no 'mm' pair: those stay on the gather/scatter
    path. The one-hot selection matmuls spare a TPU its slow indexing; on a
    card each pair costs ~60 dispatched operators a matvec, where the
    gather/scatter of all pairs together costs a handful."""
    con = spec.contact
    if not con.pair_desc:
        return None
    cq_vert = con.cq_vert
    if not isinstance(cq_vert, np.ndarray):  # a spec already moved
        cq_vert = cq_vert.cpu().numpy()
    diag_ranges, mm_ranges, gen_ranges = [], [], []
    for pi, (cq_start, count, _fs, _nf, is_self) in enumerate(con.pair_desc):
        frozen_q = (pi < len(con.frozen_src) and con.frozen_src[pi]
                    and not is_self)
        v_lo = int(cq_vert[cq_start])
        contig = bool(
            (cq_vert[cq_start : cq_start + count]
             == np.arange(v_lo, v_lo + count)).all()
        )
        if frozen_q and contig:
            diag_ranges.append((cq_start, count, v_lo))
            continue
        if (mm and contig and not is_self and con.mm_budget > 0
                and pi < len(con.src_vrange)):
            f_vlo, f_vn = con.src_vrange[pi]
            if f_vn > 0 and count * 3 * f_vn <= con.mm_budget:
                mm_ranges.append((cq_start, count, v_lo, f_vlo, f_vn))
                continue
        gen_ranges.append((cq_start, count))
    if not diag_ranges and not mm_ranges:
        return None
    return tuple(diag_ranges), tuple(mm_ranges), tuple(gen_ranges)
