"""Block-cyclic-reduction (BCR) direct solver over cloth grids, the core of
the adjoint GMRES preconditioner (counterpart of
`thinshelllab_tpu/engine/gridsolve.py`).

The cloth's static stencil spans at most two grid rows and columns (13 DIA
lanes, |di|, |dj| <= 2). Grouping grid rows in pairs makes that operator
block tridiagonal with dense (6(M+1), 6(M+1)) blocks, and cyclic reduction
factors it in ceil(log2) levels of batched dense products and inverses.
`extract_cloth_tridiag` builds the block tridiagonal from a DIA store plus
the contact block diagonal, which is exact for contacts against fully
frozen bodies (cloth on the table: only the query vertex's 3x3 diagonal
survives the frozen mask).
"""
from __future__ import annotations

import numpy as np
import torch


def build_grid_plan(spec):
    """Host-side plan: per cloth covered by the DIA store, the lane ->
    (di, dj) grid-shift decomposition. Returns a list of
    (N, M, v_off, lanes) with lanes = ((lane_index, di, dj), ...).

    o = di*(M+1) + dj with |di|, |dj| <= 2 is unique for M+1 > 4; lanes that
    do not decompose inside the window carry no cloth values at cloth rows
    and are skipped."""
    if spec.dia is None:
        return []
    plan = []
    offsets = spec.dia.offsets
    for (N, M, v_off, _fb, _hb, _fams, _res) in spec.dia.cloths:
        W = M + 1
        if W <= 4:
            continue
        lanes = []
        for oi, o in enumerate(offsets):
            for dj in range(-2, 3):
                if (o - dj) % W == 0:
                    di = (o - dj) // W
                    if abs(di) <= 2:
                        lanes.append((oi, di, dj))
                        break
        plan.append((N, M, v_off, tuple(lanes)))
    return plan


def contact_coupling_slots(spec, gp):
    """Host-side (the numpy spec of core.builder): for each planned
    cloth, the contact slot indices (numpy int64) of the non-self pairs
    whose source faces belong to that cloth, or None. Their source-face
    vertex pairs carry in-band couplings that belong in the cloth
    tridiagonal; leaving them out makes the Krylov iteration count grow
    with the active contact count."""
    faces = np.asarray(spec.faces)
    out = []
    for (N, M, v_off, _lanes) in gp:
        lo, hi = v_off, v_off + (N + 1) * (M + 1)
        slots = []
        for (cq_start, count, f_start, _nf, is_self) in spec.contact.pair_desc:
            if is_self:
                continue
            f0 = faces[f_start]
            if np.all((f0 >= lo) & (f0 < hi)):
                slots.append(np.arange(cq_start, cq_start + count))
        out.append(np.concatenate(slots) if slots else None)
    return out


def add_contact_couplings(spec, gp, slot_lists, dia, con_idx, con_H):
    """A COPY of the DIA store with the off-diagonal 3x3 blocks of the
    cloth-source contact constraints added at their lanes (offsets +-1,
    +-(W-1), +-W, +-(W+1) are cloth lanes), so that the tridiagonal
    extraction picks them up; the store the operator applies is unchanged.
    con_idx (C, 4), con_H (C, 4, 4, 3, 3) are the merged barrier+friction
    group. Entries with a vertex outside the cloth or no lane land on the
    ghost row NV, which the extraction never reads."""
    offsets = spec.dia.offsets
    NV = spec.NV
    dev = dia.device
    lanes_all, rows_all, vals_all = [], [], []
    for (N, M, v_off, _lanes), slots in zip(gp, slot_lists):
        if slots is None:
            continue
        W = M + 1
        R = N + 1
        span = 2 * W + 2
        lut = np.full((2 * span + 1,), -1, np.int64)
        for li, o in enumerate(offsets):
            if -span <= o <= span:
                lut[o + span] = li
        lut = torch.as_tensor(lut, device=dev)
        ii = con_idx[torch.as_tensor(slots, device=dev)]  # (S, 4)
        H_s = con_H[torch.as_tensor(slots, device=dev)]
        for a in range(4):
            for b in range(4):
                if a == b:
                    continue
                va, vb = ii[:, a], ii[:, b]
                ina = (va >= v_off) & (va < v_off + R * W)
                inb = (vb >= v_off) & (vb < v_off + R * W)
                lane = lut[torch.clamp(vb - va + span, 0, 2 * span)]
                ok = ina & inb & (lane >= 0)
                lanes_all.append(torch.where(ok, lane, 0))
                rows_all.append(torch.where(ok, va, NV))
                vals_all.append(H_s[:, a, b]
                                * ok[:, None, None].to(con_H.dtype))
    if not lanes_all:
        return dia
    out = dia.clone()
    # (n_off, NVp, 3, 3) view: the two advanced indices are adjacent there,
    # so the (S12, 3, 3) values line up with the indexed blocks
    out.permute(0, 3, 1, 2).index_put_(
        (torch.cat(lanes_all), torch.cat(rows_all)), torch.cat(vals_all),
        accumulate=True)
    return out


def extract_cloth_tridiag(spec, gp_entry, dia, Dc=None):
    """(D, U) for one cloth: D (nb, m, m) diagonal blocks, U (nb, m, m)
    super-diagonal couplings (U[k]: block k -> k+1; U[nb-1] zero), with
    m = 6(M+1) and nb = ceil((N+1)/2) (odd N+1 padded with identity rows).

    Frozen DOFs are masked to zero rows and columns and the inertia diagonal
    mass/dt^2 is added for every real vertex (frozen rows become pure
    inertia, as in hvp_dia_static); padded rows get a unit diagonal. Dc
    (NV, 3, 3), when given, adds the dynamic contact block diagonal."""
    N, M, v_off, lanes = gp_entry
    W = M + 1
    R = N + 1
    nb = (R + 1) // 2
    Rp = 2 * nb
    dt_, dev = dia.dtype, dia.device

    unf = spec.dev.unf.to(dt_)[v_off : v_off + R * W]  # (RW, 3)
    unf_g = unf.reshape(R, W, 3).permute(2, 0, 1)  # (3, R, W)
    eye_dj = {dj: torch.as_tensor(np.eye(W, k=dj), dtype=dt_, device=dev)
              for dj in range(-2, 3)}

    D = dia.new_zeros((nb, 2, W, 3, 2, W, 3))
    L = dia.new_zeros((nb, 2, W, 3, 2, W, 3))  # block k -> k-1
    U = dia.new_zeros((nb, 2, W, 3, 2, W, 3))
    cm_full = dia.new_zeros((3, R + 4, W + 4))
    cm_full[:, 2 : 2 + R, 2 : 2 + W] = unf_g

    for (oi, di, dj) in lanes:
        val = dia[oi, :, :, v_off : v_off + R * W].reshape(3, 3, R, W)
        val = val * unf_g[:, None]  # row mask (i at the row vertex)
        # column mask: unfrozen at (r+di, c+dj), zero outside the grid
        cm = cm_full[:, 2 + di : 2 + di + R, 2 + dj : 2 + dj + W]
        val = val * cm[None, :]
        if Rp > R:
            val = torch.cat([val, val.new_zeros((3, 3, Rp - R, W))], dim=2)
        for p in (0, 1):
            vp = val[:, :, p::2, :]  # (3, 3, nb, W)
            s = (p + di) // 2  # floor division
            p2 = (p + di) - 2 * s
            band = torch.einsum("ijkc,cd->kcidj", vp, eye_dj[dj])
            if s == 0:
                D[:, p, :, :, p2] += band
            elif s == 1:
                # rows in the last block coupling "up" are zero by assembly
                U[:, p, :, :, p2] += band
            elif s == -1:
                L[:, p, :, :, p2] += band
            # |s| == 2 is impossible for |di| <= 2 with p in {0, 1}

    m = 6 * W
    D = D.reshape(nb, m, m)
    U = U.reshape(nb, m, m)
    L = L.reshape(nb, m, m)
    # exact symmetry; L[k] couples block k -> k-1, so it is U[k-1]^T
    D = 0.5 * (D + D.transpose(-1, -2))
    U[:-1] = 0.5 * (U[:-1] + L[1:].transpose(-1, -2))

    # block-diagonal additions: inertia (+ contact diagonal)
    md = spec.mass.to(dt_)[v_off : v_off + R * W]
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    B = md[:, None, None] / spec.dt**2 * eye3[None]  # (RW, 3, 3)
    if Dc is not None:
        unfm = unf[:, :, None] * unf[:, None, :]
        B = B + Dc[v_off : v_off + R * W].to(dt_) * unfm
    if Rp > R:
        B = torch.cat([B, eye3.expand((Rp - R) * W, 3, 3)], dim=0)
    B = B.reshape(nb, 2 * W, 3, 3)
    q = 2 * W
    Dd = torch.einsum("kqij,qr->kqirj", B, torch.eye(q, dtype=dt_, device=dev))
    return D + Dd.reshape(nb, m, m), U


def _safe_inv(A, eps):
    """Inverse of each block with a relative diagonal shift of eps times its
    largest |entry| (a near-singular pivot gives a finite, slightly damped
    inverse). inv_ex without the error check: no host sync, no raise, as
    the JAX inverse."""
    dt_ = A.dtype
    scale = torch.amax(torch.abs(A), dim=(-2, -1), keepdim=True)
    shift = eps * torch.clamp(scale, min=torch.finfo(dt_).tiny)
    eye = torch.eye(A.shape[-1], dtype=dt_, device=A.device)
    return torch.linalg.inv_ex(A + shift * eye, check_errors=False)[0]


def factor_tridiag(D, U, cutoff=4):
    """Cyclic-reduction factorization of the block tridiagonal (D_k, U_k).
    Returns (levels, root_inv) for solve_tridiag. Odd level sizes are padded
    with a decoupled identity block. Reduction stops once <= `cutoff`
    blocks remain, and that root system is inverted densely once.

    Every pivot block gets a relative diagonal shift of 100 eps x its
    max |entry| (_safe_inv): the extracted tridiagonal is a restriction of
    the operator and need not be definite."""
    levels = []
    n, m = D.shape[0], D.shape[1]
    dt_, dev = D.dtype, D.device
    eps = 100.0 * torch.finfo(dt_).eps
    while n > cutoff:
        padded = n % 2 == 1
        if padded:
            D = torch.cat([D, torch.eye(m, dtype=dt_, device=dev)[None]])
            U = torch.cat([U, U.new_zeros((1, m, m))])
            n += 1
        n2 = n // 2
        Dodd_inv = _safe_inv(D[1::2], eps)  # (n2, m, m)
        U_even = U[0::2]  # U_{2t}: even -> odd (right neighbour)
        U_odd = U[1::2]   # U_{2t+1}: odd -> even (next)
        G1 = torch.matmul(U_even, Dodd_inv)
        G2 = torch.matmul(U_odd.transpose(-1, -2), Dodd_inv)
        term_r = torch.matmul(G1, U_even.transpose(-1, -2))
        term_l = torch.matmul(G2, U_odd)
        Dnew = D[0::2] - term_r
        Dnew[1:] -= term_l[:-1]
        Unew = -torch.matmul(G1, U_odd)
        # the apply-time operator pairs, stacked once: [G1; G2] for the
        # forward correction, [U_even^T; U_odd[:-1]] for the back-substitution
        G12 = torch.cat([G1, G2])
        UUT = torch.cat([U_even.transpose(-1, -2), U_odd[:-1]])
        levels.append((Dodd_inv, G12, UUT, padded))
        D, U, n = Dnew, Unew, n2
    # dense root: the remaining n-block tridiagonal, inverted once
    B = D.new_zeros((n, n, m, m))
    ar = torch.arange(n, device=dev)
    B[ar, ar] = D
    if n > 1:
        B[ar[:-1], ar[1:]] = U[:-1]
        B[ar[1:], ar[:-1]] = U[:-1].transpose(-1, -2)
    T = B.permute(0, 2, 1, 3).reshape(n * m, n * m)
    return levels, _safe_inv(T, eps)


def _bmv(A, x):
    """Batched matvec: (k, a, b) @ (k, b) -> (k, a)."""
    return torch.matmul(A, x[..., None])[..., 0]


def solve_tridiag(fac, b):
    """Solve T x = b given factor_tridiag's output. b: (nb, m). Each
    level's two matvec families run as one stacked batched product."""
    levels, root_inv = fac
    stack = []
    for (_Dodd_inv, G12, _UUT, padded) in levels:
        if padded:
            b = torch.cat([b, b.new_zeros((1, b.shape[1]))])
        b_odd = b[1::2]
        k = b_odd.shape[0]
        t = _bmv(G12, torch.cat([b_odd, b_odd]))
        b_new = b[0::2] - t[:k]
        b_new[1:] -= t[k:][:-1]
        stack.append(b_odd)
        b = b_new
    m = b.shape[1]
    n_root = root_inv.shape[0] // m
    x = (root_inv @ b[:n_root].reshape(-1)).reshape(n_root, m)
    for (Dodd_inv, _G12, UUT, padded) in reversed(levels):
        b_odd = stack.pop()
        # x_odd[t] = Dinv_{2t+1} (b_odd[t] - U_{2t}^T x_{2t}
        #                                   - U_{2t+1} x_{2t+2})
        k = b_odd.shape[0]
        t = _bmv(UUT, torch.cat([x, x[1:]]))
        rhs = b_odd - t[:k]
        rhs[:-1] -= t[k:]
        x_odd = _bmv(Dodd_inv, rhs)
        n = x.shape[0] + x_odd.shape[0]
        xi = x.new_empty((n, m))
        xi[0::2] = x
        xi[1::2] = x_odd
        x = xi[: n - 1] if padded else xi
    return x


class GridPreconditioner:
    """Exact BCR solve on each planned cloth's static tridiagonal (+ contact
    diagonal), block-Jacobi (Dinv_rest, (NV, 3, 3)) everywhere else. Built
    once per linear system; apply() is a fixed linear map."""

    def __init__(self, spec, gp, dia, Dinv_rest, Dc=None, cutoff=None):
        if cutoff is None:
            cutoff = spec.bcr_cutoff
        self.spec = spec
        self.gp = gp
        self.Dinv_rest = Dinv_rest
        self.facs = []
        mask = np.zeros((spec.NV,), bool)
        for entry in gp:
            N, M, v_off, _ = entry
            D, U = extract_cloth_tridiag(spec, entry, dia, Dc)
            self.facs.append(factor_tridiag(D, U, cutoff=cutoff))
            mask[v_off : v_off + (N + 1) * (M + 1)] = True
        self.mask = torch.as_tensor(mask, device=dia.device)

    def apply(self, r):
        z = torch.einsum("nij,nj->ni", self.Dinv_rest, r)
        z = torch.where(self.mask[:, None], torch.zeros_like(z), z)
        for (N, M, v_off, _), fac in zip(self.gp, self.facs):
            W, R = M + 1, N + 1
            nb = (R + 1) // 2
            rc = r[v_off : v_off + R * W].reshape(-1)  # (3RW,)
            if 2 * nb > R:
                rc = torch.cat([rc, rc.new_zeros(((2 * nb - R) * W * 3,))])
            xc = solve_tridiag(fac, rc.reshape(nb, 6 * W))
            z[v_off : v_off + R * W] = xc.reshape(-1)[: R * W * 3].reshape(
                R * W, 3)
        return z
