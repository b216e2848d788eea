"""Collision pipeline: broadphase candidates, closest point-triangle
projection and the contact constraint set (counterpart of
`thinshelllab_tpu/ops/collision.py`; reference engine/geometry.py:23-229
and BaseScene.contact_pair_analysis:778-835).

The broadphase is, per contact pair, either the dense L-inf sweep (each
query vertex against all of the pair's source-face centroids, the K
nearest kept) or, for pairs with at least `ContactSpec.hash_min_faces`
source faces and a builder hash descriptor, a spatial hash: the centroids
counting-sorted into a static grid of cell size 2 grid_h, each query
reading at most `cap` faces from each of its 27 neighbour cells and
keeping the 2K nearest of those. Self-contact pairs (a body against its
own faces) skip the faces incident to the query vertex and accept only
face-interior projections.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.spec import ContactSet, SceneSpec
from .energies import _cross, _dot, _norm


# 3x3x3 neighbourhood offsets of the spatial-hash broadphase
_OFF27 = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    np.int64)
# (27, 27) strictly lower triangle: neighbour b repeats an earlier a
_TRIL27 = np.tril(np.ones((27, 27), bool), -1)


def _cells(x, origin, cutoff, G):
    """Integer grid coordinates of points x, clamped into the (Gx, Gy, Gz)
    grid: (..., 3) int64."""
    hi = torch.tensor(G, dtype=torch.int64, device=x.device) - 1
    c = torch.floor((x - origin) / cutoff).to(torch.int64)
    return torch.minimum(torch.clamp(c, min=0), hi)


def _hash_grid(cent, cutoff, G):
    """Counting-sort the source centroids into the static (Gx, Gy, Gz) grid
    of cell size `cutoff`: (origin, sorted cell ids, face permutation). The
    origin follows the centroids; coordinates clamp into the grid, which
    merges out-of-range faces into boundary cells (a superset of the
    candidates, never a miss). The sort is stable, as the JAX package's
    sort_key_val."""
    _, Gy, Gz = G
    origin = torch.amin(cent, dim=0)
    cell = _cells(cent, origin, cutoff, G)
    cid = (cell[:, 0] * Gy + cell[:, 1]) * Gz + cell[:, 2]
    sc, perm = torch.sort(cid, stable=True)
    return origin, sc, perm


def _hash_candidates(origin, sc, perm, q, cutoff, G, cap):
    """Per query: at most `cap` faces from each of the 27 neighbour cells of
    its cell. Every face whose centroid lies within L-inf `cutoff` of q is
    among them (cell size == cutoff) while no cell holds more than cap
    faces. Returns (cand (c, 27 cap) local face ids, ok (c, 27 cap)); the
    shapes depend on cap only."""
    nf = sc.shape[0]
    _, Gy, Gz = G
    dev = q.device
    hi = torch.tensor(G, dtype=torch.int64, device=dev) - 1
    qcell = _cells(q, origin, cutoff, G)
    neigh = torch.minimum(torch.clamp(
        qcell[:, None, :] + torch.as_tensor(_OFF27, device=dev)[None],
        min=0), hi)
    ncid = (neigh[..., 0] * Gy + neigh[..., 1]) * Gz + neigh[..., 2]
    # boundary clamping can collapse distinct offsets onto one cell; the
    # repeats are masked so that duplicates never crowd out real candidates
    eq = ncid[:, :, None] == ncid[:, None, :]
    is_dup = torch.any(eq & torch.as_tensor(_TRIL27, device=dev)[None],
                       dim=2)
    start = torch.searchsorted(sc, ncid, right=False)  # (c, 27)
    idxs = start[..., None] + torch.arange(cap, device=dev)
    inb = idxs < nf
    idxs = torch.clamp(idxs, max=nf - 1)
    ok = inb & (sc[idxs] == ncid[..., None]) & ~is_dup[..., None]
    cand = perm[idxs]
    return cand.reshape(q.shape[0], -1), ok.reshape(q.shape[0], -1)


def pt2tri(x, p1, p2, p3):
    """Closest-point classification of x against triangle (p1, p2, p3),
    batched over leading axes. Returns (case, d, w): case 0 interior,
    1/2/3 vertex, -3/-1/-2 edges (12/23/31), distance d, barycentric
    weights w (..., 3). Mirrors reference geometry.pt2tri."""
    e1 = (p2 - p1) / _norm(p2 - p1)[..., None]
    e2 = (p3 - p2) / _norm(p3 - p2)[..., None]
    e3 = (p1 - p3) / _norm(p1 - p3)[..., None]
    n = -_cross(e1, e3)
    n = n / _norm(n)[..., None]
    x1 = x - _dot(x - p1, n)[..., None] * n

    out12 = _dot(_cross(x1 - p1, e1), n) > 0
    out23 = _dot(_cross(x1 - p2, e2), n) > 0
    out31 = _dot(_cross(x1 - p3, e3), n) > 0

    d_p1 = _norm(x - p1)
    d_p2 = _norm(x - p2)
    d_p3 = _norm(x - p3)

    def edge_proj(a, b, ea):
        alpha = _dot(x1 - a, ea) / _dot(b - a, ea)
        xp = a + alpha[..., None] * (b - a)
        return alpha, _norm(x - xp)

    a12, d_e12 = edge_proj(p1, p2, e1)
    a23, d_e23 = edge_proj(p2, p3, e2)
    a31, d_e31 = edge_proj(p3, p1, e3)

    S = _norm(_cross(p3 - p1, p2 - p1))
    w1 = _dot(_cross(p3 - p2, x1 - p2), n) / S
    w2 = _dot(_cross(p1 - p3, x1 - p3), n) / S
    w3 = _dot(_cross(p2 - p1, x1 - p1), n) / S
    d_int = _norm(x - x1)

    one, zero = torch.ones_like(a12), torch.zeros_like(a12)
    e100 = torch.stack([one, zero, zero], -1)
    e010 = torch.stack([zero, one, zero], -1)
    e001 = torch.stack([zero, zero, one], -1)

    def wv(c, a, b):
        return torch.where(c[..., None], a, b)

    # region 12: vertex p1 / vertex p2 / edge 12
    in12_p1 = _dot(x1 - p1, e1) < 0
    in12_p2 = _dot(x1 - p2, e1) > 0
    c12 = torch.where(in12_p1, 1, torch.where(in12_p2, 2, -3))
    d12 = torch.where(in12_p1, d_p1, torch.where(in12_p2, d_p2, d_e12))
    w12 = wv(in12_p1, e100,
             wv(in12_p2, e010, torch.stack([1 - a12, a12, 0.0 * a12], -1)))
    # region 23
    in23_p2 = _dot(x1 - p2, e2) < 0
    in23_p3 = _dot(x1 - p3, e2) > 0
    c23 = torch.where(in23_p2, 2, torch.where(in23_p3, 3, -1))
    d23 = torch.where(in23_p2, d_p2, torch.where(in23_p3, d_p3, d_e23))
    w23 = wv(in23_p2, e010,
             wv(in23_p3, e001, torch.stack([0.0 * a23, 1 - a23, a23], -1)))
    # region 31
    in31_p3 = _dot(x1 - p3, e3) < 0
    in31_p1 = _dot(x1 - p1, e3) > 0
    c31 = torch.where(in31_p3, 3, torch.where(in31_p1, 1, -2))
    d31 = torch.where(in31_p3, d_p3, torch.where(in31_p1, d_p1, d_e31))
    w31 = wv(in31_p3, e001,
             wv(in31_p1, e100, torch.stack([a31, 0.0 * a31, 1 - a31], -1)))

    case = torch.where(out12, c12, torch.where(out23, c23,
                                               torch.where(out31, c31, 0)))
    d = torch.where(out12, d12, torch.where(out23, d23,
                                            torch.where(out31, d31, d_int)))
    w_int = torch.stack([w1, w2, w3], -1)
    w = wv(out12, w12, wv(out23, w23, wv(out31, w31, w_int)))
    return case, d, w


def vertex_normals(pos, faces, NV):
    """Area-weighted vertex normals (reference BaseScene.calc_vn:837-850)."""
    v1 = pos[faces[:, 0]]
    n = _cross(pos[faces[:, 1]] - v1, pos[faces[:, 2]] - v1)
    vn = torch.zeros((NV, 3), dtype=pos.dtype, device=pos.device)
    for k in range(3):
        vn.index_add_(0, faces[:, k], n)
    norm = torch.linalg.vector_norm(vn, dim=1, keepdim=True)
    return vn / torch.clamp(norm, min=torch.finfo(pos.dtype).tiny)


def _nearest_k(linf, K):
    """Indices of the K smallest entries per row, ascending, ties to the
    lower index (the order jax.lax.top_k of -linf gives)."""
    return torch.sort(linf, dim=1, stable=True).indices[:, :K]


def _first_argmax(score):
    """Index of the first maximum of each row, as jnp.argmax gives it (all
    -inf rows included): torch.argmax on CUDA does not promise which of
    equal maxima it returns."""
    K = score.shape[1]
    ar = torch.arange(K, device=score.device)
    is_max = score == torch.amax(score, dim=1, keepdim=True)
    return torch.amin(torch.where(is_max, ar, K), dim=1)


def projection_query(spec: SceneSpec, pos, vn, proj_flag, proj_dir):
    """For each contact query slot, find the closest source-body face and
    update the latched (proj_flag, proj_dir); also returns the chosen
    triangle (C, 3) and its barycentric weights (C, 3).

    Per pair: an L-inf centroid distance matrix of the pair's queries
    against only its own source faces (chunked to 32M elements), the K
    nearest faces, then the exact point-triangle test on those K. A pair
    with a hash descriptor and at least hash_min_faces source faces reads
    its candidates from the spatial hash instead and keeps the 2K
    nearest. Candidates are ordered by (L-inf distance, position), the
    order of jax.lax.top_k, since the order decides exact ties in the
    near-window."""
    con = spec.contact
    faces = spec.faces
    centroids = (pos[faces[:, 0]] + pos[faces[:, 1]] + pos[faces[:, 2]]) / 3.0
    cutoff = 2.0 * spec.grid_h
    max_elems = 32 * 1024 * 1024  # bound the (chunk, nf) distance matrix
    tiny = torch.finfo(pos.dtype).tiny

    def detail(vid, cand_f, cand_ok, is_self):
        """Exact evaluation of K candidates for a batch of queries."""
        x = pos[vid]            # (c, 3)
        tri = faces[cand_f]     # (c, K, 3)
        if is_self:
            incident = torch.any(tri == vid[:, None, None], dim=2)
            cand_ok = cand_ok & ~incident
        p1, p2, p3 = pos[tri[..., 0]], pos[tri[..., 1]], pos[tri[..., 2]]
        case, d, w = pt2tri(x[:, None, :], p1, p2, p3)
        vt = w[..., 0:1] * p1 + w[..., 1:2] * p2 + w[..., 2:3] * p3
        nt = _cross(p2 - p1, p3 - p1)
        nt = nt / torch.clamp(torch.linalg.vector_norm(nt, dim=-1, keepdim=True),
                              min=tiny)
        cos = torch.sum((x[:, None] - vt) * nt, dim=-1)
        d = torch.where(cand_ok, d, torch.full_like(d, float("inf")))
        d_min = torch.amin(d, dim=1, keepdim=True)
        near = d < d_min + 1e-5
        score = torch.where(near, cos, torch.full_like(cos, -float("inf")))
        best = _first_argmax(score)
        rows = torch.arange(vid.shape[0], device=pos.device)
        found = torch.isfinite(d_min[:, 0])
        if is_self:
            # self-contact accepts face-interior projections only
            # (reference geometry_self.project_pair_self:166-230)
            found = found & (case[rows, best] == 0)
        return found, tri[rows, best], w[rows, best]

    C = con.capacity
    found = torch.zeros((C,), dtype=torch.bool, device=pos.device)
    # default to a real (non-degenerate) triangle so inactive slots never
    # produce NaNs through the masked barrier/friction evaluations
    tri_out = faces[-1].expand(C, 3).clone()
    w_out = torch.tensor([1.0, 0.0, 0.0], dtype=pos.dtype,
                         device=pos.device).expand(C, 3).clone()

    for pi, (cq_start, count, f_start, nf, is_self) in enumerate(
            con.pair_desc):
        K = min(con.top_k, nf)
        cent = centroids[f_start : f_start + nf]
        hd = con.hash_desc[pi] if pi < len(con.hash_desc) else None
        if nf < con.hash_min_faces:
            hd = None  # the dense sweep below the crossover
        if hd is not None:
            grid = _hash_grid(cent, cutoff, hd[:3])  # once per pair
        chunk = max(1, min(count, max(1, max_elems // max(nf, 1))))
        for lo in range(0, count, chunk):
            hi = min(count, lo + chunk)
            vid = con.cq_vert[cq_start + lo : cq_start + hi]
            q = pos[vid]
            if hd is not None:
                cand, okh = _hash_candidates(*grid, q, cutoff, hd[:3], hd[3])
                linf = torch.amax(torch.abs(cent[cand] - q[:, None, :]),
                                  dim=-1)
                linf = torch.where(okh, linf,
                                   torch.full_like(linf, float("inf")))
                # the prefilter makes a deeper exact stage cheap: twice the
                # dense path's budget of candidates
                sel = _nearest_k(linf, min(2 * K, cand.shape[1]))
                cand_f = f_start + torch.gather(cand, 1, sel)
            else:
                linf = torch.abs(cent[None, :, 0] - q[:, None, 0])
                for dim in (1, 2):
                    linf = torch.maximum(
                        linf, torch.abs(cent[None, :, dim] - q[:, None, dim]))
                sel = _nearest_k(linf, K)
                cand_f = f_start + sel
            cand_ok = torch.gather(linf, 1, sel) < cutoff
            f, t, w = detail(vid, cand_f, cand_ok, is_self)
            found[cq_start + lo : cq_start + hi] = f
            tri_out[cq_start + lo : cq_start + hi] = t
            w_out[cq_start + lo : cq_start + hi] = w

    # latched side: set dir at the 0 -> 1 transition of proj_flag
    v = torch.einsum("ck,ckd->cd", w_out, pos[tri_out])
    n = torch.einsum("ck,ckd->cd", w_out, vn[tri_out])
    xq = pos[con.cq_vert]
    new_dir = (torch.sum((xq - v) * n, dim=1) > 0).to(proj_dir.dtype)
    first = (proj_flag == 0) & found
    proj_dir = torch.where(first, new_dir, proj_dir)
    proj_flag = found.to(proj_flag.dtype)
    return proj_flag, proj_dir, tri_out, w_out


def contact_analysis(spec: SceneSpec, params_mu_pairs, pos, prev_pos,
                     proj_flag, proj_dir, tri, w):
    """Build the fixed-capacity constraint set (reference
    BaseScene.contact_pair_analysis:778-816)."""
    con = spec.contact
    mu = params_mu_pairs[con.cq_mu_id]
    vid = con.cq_vert

    # orient: if latched dir == 0, flip normal by swapping triangle verts 1,2
    flip = proj_dir == 0
    i0 = tri[:, 0]
    i1 = torch.where(flip, tri[:, 2], tri[:, 1])
    i2 = torch.where(flip, tri[:, 1], tri[:, 2])
    w1 = torch.where(flip, w[:, 2], w[:, 1])
    w2 = torch.where(flip, w[:, 1], w[:, 2])
    wv = torch.stack([w[:, 0], w1, w2], dim=1)
    idx = torch.stack([i0, i1, i2, vid], dim=1)

    n_c = _cross(pos[i1] - pos[i0], pos[i2] - pos[i0])
    # dtype-aware guard: a degenerate (masked-slot) face must not yield 0/0
    n_c = n_c / torch.clamp(torch.linalg.vector_norm(n_c, dim=1, keepdim=True),
                            min=torch.finfo(pos.dtype).tiny)

    x_c = torch.einsum("ck,ckd->cd", wv, pos[idx[:, :3]])
    x0_c = torch.einsum("ck,ckd->cd", wv, prev_pos[idx[:, :3]])
    gap = torch.sum((pos[vid] - x_c) * n_c, dim=1)
    active = (proj_flag == 1) & (gap < spec.eps_contact)

    pressure_force = spec.k_contact * (gap - spec.eps_contact)
    k = -mu * pressure_force
    dx0 = prev_pos[vid] - x0_c

    # tangent frame (reference :804-811; deliberately not orthonormalized)
    small = torch.abs(n_c[:, 0]) < 0.5
    t1 = torch.where(
        small[:, None],
        torch.stack([n_c[:, 0], n_c[:, 2], -n_c[:, 1]], dim=1),
        torch.stack([n_c[:, 1], -n_c[:, 0], n_c[:, 2]], dim=1),
    )
    t2 = _cross(n_c, t1)
    t1 = _cross(n_c, t2)
    T = torch.stack([t1, t2], dim=1)
    return ContactSet(active=active, idx=idx, w=wv, n=n_c, k=k, mu=mu,
                      dx0=dx0, T=T)
