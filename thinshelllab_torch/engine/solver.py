"""The forward linear solves, the Newton loops and the adjoint's linear
solve (counterpart of `thinshelllab_tpu/engine/solver.py`).

  * `solve_dense`: the (3NV, 3NV) Hessian assembled and LU-solved, for
    small scenes (`solver='dense'`, the JAX builder's 'auto' below 6000
    DOF).
  * `_solve_cg_prepared_T`: preconditioned CG in the transposed (3, NVp)
    layout on the hybrid-DIA operator. The preconditioner is the damped
    block-Jacobi smoothing polynomial: the fused `dia_precond` CUDA kernels
    when the SpMV route is the kernel (`elements.use_spmv_kernel`), the
    per-sweep plain polynomial of the cheap operator otherwise.
  * `solve_cg_prepared` on a scene without a DIA plan (a cloth too narrow
    for the plan, e.g. folding): block-Jacobi CG in the (NV, 3) layout on
    the pull operator (`elements.hvp_pull`), or on the plain scatter
    operator (`elements.hvp`) without hvp slots.
  * `newton_solve`: full Newton (`hess_refresh=1` or the dense solver:
    Hessian, residual and solve every iteration, an energy-only
    backtracking line search) or the macro/micro modified Newton of the
    JAX package (operator rebuilt every `hess_refresh` iterations,
    residual fresh every iteration, the line search on the fused
    energy+force evaluation).
  * `solve_adjoint`: the dense solve on the dense path; restarted GMRES
    on the adjoint's true (indefinite) Hessian, right-preconditioned by
    the BCR solve of each cloth's tridiagonal
    (`gridsolve.GridPreconditioner`), on a scene with a DIA cloth grid
    plan; left-preconditioned MINRES (`solve_minres`, the |H| element
    blocks as its SPD preconditioner) otherwise.

The JAX package runs these loops as `lax.while_loop`s on the device. Here
they are Python loops: every loop test reads one scalar back to the host
(a device sync per CG iteration, per line-search trial, per Newton
iteration, per GMRES iteration and per GMRES restart), with the arithmetic
unchanged.
"""
from __future__ import annotations

import torch

from ..core.spec import SceneSpec
from ..ops import dia_spmv as _spmv
from ..ops import spd
from . import elements, gridsolve


def _inv3x3(A):
    """Batched closed-form 3x3 inverse via the adjugate, with a
    finfo(dtype).tiny guard on the determinant."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    tiny = torch.finfo(det.dtype).tiny
    inv_det = 1.0 / torch.where(torch.abs(det) > tiny, det,
                                torch.full_like(det, tiny))
    out = torch.stack([A11, A12, A13, A21, A22, A23, A31, A32, A33],
                      dim=-1).reshape(A.shape)
    return out * inv_det[..., None, None]


def _safe_div(num, den):
    """num / den with |den| <= tiny replaced by tiny (f32-safe guard)."""
    tiny = torch.finfo(den.dtype).tiny
    return num / torch.where(torch.abs(den) > tiny, den,
                             torch.full_like(den, tiny))


def solve_dense(spec: SceneSpec, groups, F):
    """LU solve of the assembled Hessian, H p = F. `solve_ex` without its
    error check keeps the JAX solve's semantics on a singular H (inf/NaN,
    no exception): the adjoint solves the true, possibly indefinite
    Hessian."""
    H = elements.dense_hessian(spec, groups)
    p, _info = torch.linalg.solve_ex(H, F.reshape(-1), check_errors=False)
    return p.reshape(-1, 3)


def prepare_solver_state(spec: SceneSpec, groups, dtype):
    """Everything the iterative solve needs, built once per operator: the
    DIA store, the leftover pull blocks, the preconditioner diagonals and
    the split contact blocks; without a DIA plan, the pull blocks (when
    the spec has hvp slots) and the block diagonal."""
    st = {"H": groups["H"], "idx": groups["idx"]}
    if spec.dia is None:
        if spec.hvp_slots is not None:
            st["nbr"] = elements.gather_neighbor_blocks(spec, groups, dtype)
        st["D"] = elements.diag_blocks(spec, groups)
        return st
    st["dia"] = elements.assemble_dia(spec, groups, dtype)
    if spec.hvp_slots is not None and spec.hvp_slots.D > 0:
        st["nbr"] = elements.gather_neighbor_blocks(spec, groups, dtype)
    st["D"], st["Dc"] = elements.diag_blocks_dia(
        spec, groups, st["dia"], st.get("nbr"), return_contact=True)
    ns = elements.static_block_count(spec)
    split = elements.build_contact_split(spec, st["idx"][ns:],
                                         groups["H"][ns:], dtype)
    if split is not None:
        st.update(split)
    return st


def _fused_precond_T(spec: SceneSpec, st, D, Dinv, w, smooth, dtype, unf2):
    """The damped block-Jacobi smoothing polynomial through the dia_precond
    kernels, on (3, NVp) vectors. The kernels' cheap operator is
    A' = off-band DIA + D with the full masked block diagonal D folded into
    the offset-0 lane (the leftover pull rows keep only their diagonal).
    Frozen DOFs stay zero inside the kernels; the plain recurrence there is
    the scalar fixed point z_{k+1} = (1-w) z_k + w (dt^2/m) r, added in
    closed form."""
    plan = spec.dia
    NV, NVp = spec.NV, plan.NVp
    off0 = spec.dev.off0
    unf = spec.dev.unf.to(dtype)
    dia_pre = st["dia"].clone()
    dia_pre[off0, :, :, :NV] = D.permute(1, 2, 0)
    dinv_l = D.new_zeros((3, 3, NVp), dtype=dtype)
    dinv_l[:, :, :NV] = Dinv.permute(1, 2, 0)
    coef = (spec.dt**2 / spec.mass)[:, None] * (1.0 - (1.0 - w) ** (smooth + 1))
    cf2 = D.new_zeros((3, NVp), dtype=dtype)
    cf2[:, :NV] = (coef * (1.0 - unf)).T

    def precond(r2):
        z2 = _spmv.dia_precond(dia_pre, r2 * unf2, unf2, dinv_l, plan.offsets,
                               w, smooth, spec.dev.offsets_t)
        return z2 * unf2 + cf2 * r2

    return precond


def _polynomial_precond_T(spec: SceneSpec, st, Dinv, w, smooth, dtype, unf2,
                          m2):
    """The damped block-Jacobi smoothing polynomial sweep by sweep on
    (3, NVp) vectors: z = w D^-1 r, then `smooth` sweeps
    z <- z + w D^-1 (r - A_cheap z), A_cheap the static DIA part (through
    dia_apply), the leftover pull rows and the contact diagonal. The JAX
    package's preconditioner off its kernel (f64, and f32 off a TPU)."""
    nbr = st.get("nbr")
    DinvT = elements.blocks_to_t33(spec, Dinv, dtype)
    DcT = elements.blocks_to_t33(spec, st["Dc"], dtype)

    def A_cheap(x2):
        return (elements.hvp_dia_static_T(spec, st["dia"], nbr, x2, unf2, m2)
                + torch.einsum("ijn,jn->in", DcT, x2))

    def precond(r2):
        z2 = w * torch.einsum("ijn,jn->in", DinvT, r2)
        for _ in range(smooth):
            z2 = z2 + w * torch.einsum("ijn,jn->in", DinvT, r2 - A_cheap(z2))
        return z2

    return precond


def _warm_split(A, F, x0):
    """Optimally scaled warm start: alpha = argmin |F - a A x0|. Returns
    (base, b_eff) with base = alpha x0 and b_eff = F - A base; a useless
    warm start degrades exactly to the cold start (alpha -> 0)."""
    Ax0 = A(x0)
    den = torch.sum(Ax0 * Ax0)
    tiny = torch.finfo(den.dtype).tiny
    alpha = torch.sum(F * Ax0) / torch.clamp(den, min=tiny)
    alpha = torch.where(torch.isfinite(alpha) & (den > tiny), alpha,
                        torch.zeros_like(alpha))
    return alpha * x0, F - alpha * Ax0


def solve_cg_prepared(spec: SceneSpec, st, F, return_iters=False, x0=None):
    """Block-Jacobi PCG on H p = F (frozen-masked), warm-started from x0:
    in the (3, NVp) layout with a DIA plan (_solve_cg_prepared_T), else in
    the (NV, 3) layout on the pull or plain operator. Without the cheap
    operator of a DIA plan the preconditioner is one block-Jacobi sweep
    (no smoothing), as in the JAX package. The stopping test
    |r|^2 > (fwd_tol |F|)^2 + tiny, finite, it < cg_max_iter is read on
    the host once per iteration."""
    if spec.dia is not None:
        return _solve_cg_prepared_T(spec, st, F, return_iters=return_iters,
                                    x0=x0)
    A = _ops_from_state(spec, st)
    Dinv = _inv3x3(st["D"])

    def precond(r):
        return torch.einsum("nij,nj->ni", Dinv, r)

    dtype = F.dtype
    bnorm = torch.linalg.vector_norm(F)
    fwd_tol = spec.cg_tol if spec.fwd_tol is None else spec.fwd_tol
    tol2 = (fwd_tol * bnorm) ** 2 + torch.finfo(dtype).tiny
    base, b = None, F
    if x0 is not None:
        base, b = _warm_split(A, F, x0)
    x, it = _pcg_loop(spec, A, precond, b, tol2)
    if base is not None:
        x = base + x
    return (x, it) if return_iters else x


def _pcg_loop(spec: SceneSpec, A, precond, b, tol2):
    """The PCG iteration from x = 0 on A x = b: (x, iterations)."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    it = 0
    while it < spec.cg_max_iter:
        rr = torch.sum(r * r)
        if not bool((rr > tol2) & torch.isfinite(rr)):  # host sync
            break
        Ap = A(p)
        alpha = _safe_div(rz, torch.sum(p * Ap))
        # breakdown guard: never poison x
        alpha = torch.where(torch.isfinite(alpha), alpha,
                            torch.zeros_like(alpha))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.sum(r * z)
        p = z + _safe_div(rz_new, rz) * p
        rz = rz_new
        it += 1
    return x, it


def solve_cg(spec: SceneSpec, groups, F, x0=None, return_iters=False):
    """PCG on the operator of one element group (built here)."""
    return solve_cg_prepared(spec, prepare_solver_state(spec, groups, F.dtype),
                             F, return_iters=return_iters, x0=x0)


def solve_linear(spec: SceneSpec, groups, F, x0=None, return_iters=False):
    """The forward Newton direction: the dense solve (x0 unused, 0
    iterations) or PCG warm-started from x0."""
    if spec.solver == "dense":
        p = solve_dense(spec, groups, F)
        return (p, 0) if return_iters else p
    return solve_cg(spec, groups, F, x0=x0, return_iters=return_iters)


def _solve_cg_prepared_T(spec: SceneSpec, st, F, return_iters=False,
                         x0=None):
    """PCG with every iterate in the DIA matvec's (3, NVp) layout; F
    converts at entry and x at exit. The stopping test
    |r|^2 > (fwd_tol |F|)^2 + tiny, finite, it < cg_max_iter is read on the
    host once per iteration."""
    dtype = F.dtype
    if dtype == spec.dtype:
        unf2, m2 = spec.dev.unf2, spec.dev.m2
    else:
        unf2, m2 = elements.t2_consts(spec, dtype)
    nbr = st.get("nbr")
    groups = {"idx": st["idx"], "H": st["H"]}
    for k in ("Dcon", "idx_con", "H_con", "mm_S", "mm_H"):
        if k in st:
            groups[k] = st[k]
    DconT = (elements.blocks_to_t33(spec, st["Dcon"], dtype)
             if "Dcon" in st else None)

    def A(x2):
        return (elements.hvp_dia_static_T(spec, st["dia"], nbr, x2, unf2, m2)
                + elements.hvp_dia_contact_T(spec, groups, x2, unf2, DconT))

    D = st["D"]
    Dinv = _inv3x3(D)
    smooth = spec.precond_smooth
    if smooth > 0:
        w = spec.precond_omega
        if elements.use_spmv_kernel(spec, F):
            precond = _fused_precond_T(spec, st, D, Dinv, w, smooth, dtype,
                                       unf2)
        else:
            precond = _polynomial_precond_T(spec, st, Dinv, w, smooth, dtype,
                                            unf2, m2)
    else:
        DinvT = elements.blocks_to_t33(spec, Dinv, dtype)

        def precond(r2):
            return torch.einsum("ijn,jn->in", DinvT, r2)

    bnorm = torch.linalg.vector_norm(F)
    fwd_tol = spec.cg_tol if spec.fwd_tol is None else spec.fwd_tol
    tol2 = (fwd_tol * bnorm) ** 2 + torch.finfo(dtype).tiny
    b = elements.to_t2(spec, F)
    base = None
    if x0 is not None:
        base, b = _warm_split(A, b, elements.to_t2(spec, x0))
    x, it = _pcg_loop(spec, A, precond, b, tol2)
    if base is not None:
        x = base + x
    x = elements.from_t2(spec, x)
    if return_iters:
        return x, it
    return x


def _ops_from_state(spec: SceneSpec, st):
    """The full operator A on (NV, 3) vectors from a prepared operator
    state: the hybrid-DIA operator with a DIA plan, the pull operator on a
    spec with hvp slots, else the plain scatter operator."""
    groups = {"idx": st["idx"], "H": st["H"]}
    for k in ("Dcon", "idx_con", "H_con", "mm_S", "mm_H"):
        if k in st:
            groups[k] = st[k]
    nbr = st.get("nbr")
    if spec.dia is not None:
        def A(x):
            return elements.hvp_dia(spec, st["dia"], nbr, groups, x)
    elif spec.hvp_slots is not None:
        def A(x):
            return elements.hvp_pull(spec, nbr, groups, x)
    else:
        def A(x):
            return elements.hvp(spec, groups, x)
    return A


def _cheap_op_from_state(spec: SceneSpec, st):
    """The cheap operator of the smoothing polynomial on (NV, 3) vectors
    (the static DIA part plus the contact diagonal), or None without a DIA
    plan: the second operator of the JAX package's _ops_from_state."""
    if spec.dia is None:
        return None
    nbr = st.get("nbr")

    def A_cheap(x):
        return (elements.hvp_dia_static(spec, st["dia"], nbr, x)
                + torch.einsum("nij,nj->ni", st["Dc"], x))

    return A_cheap


def solve_gmres(spec: SceneSpec, groups, F, x0=None, return_iters=False):
    """Right-preconditioned restarted GMRES on H z = F for the adjoint's
    true (unprojected, possibly indefinite) Hessian. The preconditioner is
    the exact in-band operator: the BCR factorization of each cloth's true
    tridiagonal plus the cloth-source contact couplings and the contact
    diagonal (gridsolve.GridPreconditioner), block-Jacobi |D|^-1 elsewhere."""
    st = prepare_solver_state(spec, groups, F.dtype)
    A = _ops_from_state(spec, st)
    ns = elements.static_block_count(spec)
    grid_plan = spec.dev.grid_plan  # empty: block-Jacobi |D|^-1 everywhere
    dia_pc = gridsolve.add_contact_couplings(
        spec, grid_plan, spec.dev.coupling_slots, st["dia"],
        groups["idx"][ns:], groups["H"][ns:])
    M = gridsolve.GridPreconditioner(spec, grid_plan, dia_pc,
                                     spd.abs_inv_3x3(st["D"]),
                                     st.get("Dc")).apply
    restart = min(spec.cg_max_iter, 64)
    adj_tol = spec.cg_tol if spec.adj_tol is None else spec.adj_tol
    return _gmres_loop(A, M, F, adj_tol, restart, spec.cg_max_iter, x0=x0,
                       return_iters=return_iters)


def _abs_element_blocks(H):
    """Element-wise matrix absolute value: each fused (4, 4, 3, 3) block in
    its symmetrised 12x12 form, decomposed (spd._eigh: float32 blocks in
    float64, a failure raises) and rebuilt with |eigenvalues|. |H_e| is PSD
    and spectrally equivalent to H_e away from its null directions: the
    building block of MINRES's SPD preconditioner."""
    E = H.shape[0]
    H12 = H.permute(0, 1, 3, 2, 4).reshape(E, 12, 12)
    H12 = 0.5 * (H12 + H12.transpose(-1, -2))
    w, v = spd._eigh(H12)
    H12 = torch.einsum("eik,ek,ejk->eij", v, torch.abs(w), v)
    return H12.reshape(E, 4, 3, 4, 3).permute(0, 1, 3, 2, 4)


def solve_minres(spec: SceneSpec, groups, F, return_iters=False, x0=None):
    """Preconditioned MINRES on H z = F for the adjoint's true
    (unprojected, possibly indefinite) Hessian, on a scene without a DIA
    cloth grid plan. The SPD preconditioner comes from a second operator
    assembled from the element-wise absolute values |H_e|: the BCR solve
    of its cloth tridiagonal with a grid plan (unreached through
    solve_adjoint, which takes GMRES there), the damped block-Jacobi
    smoothing polynomial of its cheap DIA operator with a DIA plan and no
    grid plan, plain block-Jacobi |D|^-1 without a DIA plan.

    Paige-Saunders MINRES with left preconditioning (the scipy layout),
    warm-started from x0 by the optimally scaled split (the tolerance
    stays relative to the original F). The loop runs while phibar > tol,
    finite and it < cg_max_iter, read on the host once per iteration."""
    st = prepare_solver_state(spec, groups, F.dtype)
    A = _ops_from_state(spec, st)
    base = None
    F_orig = F
    if x0 is not None:
        base, F = _warm_split(A, F, x0)

    gprec = {"idx": groups["idx"], "H": _abs_element_blocks(groups["H"])}
    stp = prepare_solver_state(spec, gprec, F.dtype)
    A_pc_cheap = _cheap_op_from_state(spec, stp)
    Dinv = spd.abs_inv_3x3(stp["D"])

    grid_plan = spec.dev.grid_plan
    smooth = spec.precond_smooth if A_pc_cheap is not None else 0
    if grid_plan and spec.dia is not None:
        M = gridsolve.GridPreconditioner(spec, grid_plan, stp["dia"], Dinv,
                                         stp.get("Dc")).apply
    elif smooth > 0:
        wgt = spec.precond_omega

        def M(r):
            z = wgt * torch.einsum("nij,nj->ni", Dinv, r)
            for _ in range(smooth):
                z = z + wgt * torch.einsum("nij,nj->ni", Dinv,
                                           r - A_pc_cheap(z))
            return z
    else:
        def M(r):
            return torch.einsum("nij,nj->ni", Dinv, r)

    adj_tol = spec.cg_tol if spec.adj_tol is None else spec.adj_tol
    d = F.dtype
    tiny = torch.finfo(d).tiny
    b = F
    y = M(b)
    beta1 = torch.sqrt(torch.clamp(torch.sum(b * y), min=tiny))
    if base is None:
        tol = adj_tol * beta1
    else:
        # one extra M apply: the tolerance of the original right-hand side
        yF = M(F_orig)
        tol = adj_tol * torch.sqrt(torch.clamp(torch.sum(F_orig * yF),
                                               min=tiny))

    def scalar(v):
        return torch.tensor(v, dtype=d, device=F.device)

    x = torch.zeros_like(b)
    r1, r2 = b, b
    oldb, beta, dbar, epsln = scalar(0.0), beta1, scalar(0.0), scalar(0.0)
    phibar, cs, sn = beta1, scalar(-1.0), scalar(0.0)
    w, w2 = torch.zeros_like(b), torch.zeros_like(b)
    it = 0
    while it < spec.cg_max_iter and bool(
            (phibar > tol) & torch.isfinite(phibar)):  # host sync
        v = y / beta
        yv = A(v)
        if it >= 1:
            yv = yv - (beta / oldb) * r1
        alfa = torch.sum(v * yv)
        yv = yv - (alfa / beta) * r2
        r1, r2 = r2, yv
        y = M(r2)
        oldb = beta
        beta = torch.sqrt(torch.clamp(torch.sum(r2 * y), min=tiny))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp(torch.sqrt(gbar**2 + beta**2), min=tiny)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1 = w2
        w2 = w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        it += 1
    if base is not None:
        x = base + x
    return (x, it) if return_iters else x


def _gmres_loop(A, M, b, tol, m, max_total=None, x0=None,
                return_iters=False):
    """Right-preconditioned restarted GMRES(m) with a total budget of
    max_total iterations. Each cycle solves A (M y) = r with modified
    Gram-Schmidt plus one re-orthogonalisation over a fixed (m+1)-slot
    basis, the accumulated Givens rotations carried as a dense (m+1, m+1)
    product Q, and the least-squares system solved once at exit on the
    identity-padded upper triangle.

    A cycle stops early at the tolerance, on a non-finite residual, or
    after 8 iterations that fail to improve the best residual by 3% (the
    stagnation exit). After a cycle the true residual b - A x is formed;
    the restarts stop at the tolerance, at the budget, when the true
    residual exceeds 10x the cycle's estimate (the floor of the working
    precision), or when a stagnated cycle did not halve the residual.

    The JAX loops are lax.while_loops; here each loop test reads one
    scalar on the host: a device sync per iteration and per restart."""
    n = b.numel()
    d = b.dtype
    dev = b.device
    shape = b.shape
    b_f = b.reshape(-1)
    bnorm = torch.linalg.vector_norm(b_f)
    tol_abs = tol * bnorm
    tiny = torch.finfo(d).tiny
    if max_total is None:
        max_total = m
    slot = torch.arange(m + 1, device=dev)

    def cycle(r):
        """One GMRES(m) cycle on A (M y) = r: (dx, res, k, stalled)."""
        beta = torch.linalg.vector_norm(r)
        V = r.new_zeros((m + 1, n))
        H = r.new_zeros((m + 1, m))
        Q = torch.eye(m + 1, dtype=d, device=dev)
        g = r.new_zeros((m + 1,))
        V[0] = r / torch.clamp(beta, min=tiny)
        g[0] = beta
        k, res, best = 0, beta, beta
        stall = torch.zeros((), dtype=torch.int64, device=dev)
        while k < m and bool((res > tol_abs) & torch.isfinite(res)
                             & (stall < 8)):  # host sync
            w = A(M(V[k].reshape(shape))).reshape(-1)
            # modified Gram-Schmidt against the filled basis (masked full
            # products), then one re-orthogonalisation pass
            mask = (slot <= k).to(d)
            h = (V @ w) * mask
            w = w - h @ V
            h2 = (V @ w) * mask
            w = w - h2 @ V
            h = h + h2
            wn = torch.linalg.vector_norm(w)
            h[k + 1] = wn
            V[k + 1] = w / torch.clamp(wn, min=tiny)
            # pre-rotate the new column by the accumulated rotations, then
            # the new rotation that zeroes Hc[k+1]
            Hc = Q @ h
            denom = torch.clamp(torch.sqrt(Hc[k] ** 2 + Hc[k + 1] ** 2),
                                min=tiny)
            c_new = Hc[k] / denom
            s_new = Hc[k + 1] / denom
            Hc[k] = denom
            Hc[k + 1] = 0.0
            H[:, k] = Hc
            rk = Q[k : k + 2]
            Q[k : k + 2] = torch.stack([c_new * rk[0] + s_new * rk[1],
                                        -s_new * rk[0] + c_new * rk[1]])
            gk = g[k].clone()
            g[k] = c_new * gk
            g[k + 1] = -s_new * gk
            res = torch.abs(g[k + 1])
            improved = res < 0.97 * best
            best = torch.minimum(best, res)
            stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
            k += 1

        filled = slot[:m] < k
        fm = filled[:, None] & filled[None, :]
        T = torch.where(fm, H[:m, :m], torch.eye(m, dtype=d, device=dev))
        rhs = torch.where(filled, g[:m], torch.zeros_like(g[:m]))
        y = torch.linalg.solve_triangular(T, rhs[:, None], upper=True)[:, 0]
        y = torch.where(filled, y, torch.zeros_like(y))
        return M((y @ V[:m]).reshape(shape)), res, k, stall >= 8

    if x0 is not None:
        # optimally scaled warm start; the tolerance stays relative to |b|
        x, r = _warm_split(lambda v: A(v.reshape(shape)).reshape(-1), b_f,
                           x0.reshape(-1))
        res = torch.linalg.vector_norm(r)
    else:
        x, r, res = torch.zeros_like(b_f), b_f, bnorm
    tot = 0
    stalled = torch.zeros((), dtype=torch.bool, device=dev)
    while tot < max_total and bool((res > tol_abs) & torch.isfinite(res)
                                   & ~stalled):  # host sync
        dx, res_est, k, inner_stall = cycle(r)
        x = x + dx.reshape(-1)
        r = b_f - A(x.reshape(shape)).reshape(-1)
        rn_norm = torch.linalg.vector_norm(r)
        # a true residual an order of magnitude above the Givens estimate
        # (equal in exact arithmetic) means the update's accuracy, not the
        # Krylov space, is the limit: restarting cannot help
        floor = rn_norm > 10.0 * torch.maximum(res_est, tol_abs)
        stalled = floor | (inner_stall & (rn_norm > 0.5 * res))
        res = rn_norm
        tot += max(k, 1)
    x = x.reshape(shape)
    if return_iters:
        return x, tot
    return x


def solve_adjoint(spec: SceneSpec, groups, F, x0=None, return_iters=False):
    """Linear solve of the backward sweep: direct on the dense path (0
    iterations, x0 unused), grid-preconditioned GMRES on a scene with a
    DIA cloth grid plan, MINRES with the |H| preconditioner otherwise.
    x0: optional warm start (the previous backward step's solution),
    optimally scaled so that it is never worse than a cold start."""
    if spec.solver == "dense":
        x = solve_dense(spec, groups, F)
        return (x, 0) if return_iters else x
    if spec.dia is not None and spec.dev.grid_plan:
        return solve_gmres(spec, groups, F, x0=x0, return_iters=return_iters)
    return solve_minres(spec, groups, F, x0=x0, return_iters=return_iters)


def newton_solve(spec: SceneSpec, params, pos0, prev_pos, vel, ref_angle,
                 contact, stats=None):
    """Minimize the incremental potential from the inertia predictor.
    Returns the converged positions. Both branches stop at max_newton_iter
    or when max|p|/dt < newton_tol, and on a failed line search (alpha
    below linesearch_min_alpha) leave the last trial's step applied, as
    the reference does.

    Full Newton (hess_refresh == 1 or the dense solver): every iteration
    builds the SPD-projected element Hessians and the residual, solves
    for p (warm-started from the previous direction; unused by the dense
    solve) and line-searches E(pos - alpha p) < E0 on the energy alone,
    halving alpha.

    Modified Newton (hess_refresh > 1, CG): each macro iteration rebuilds
    the operator (element Hessians, DIA store, preconditioner) and runs up
    to `hess_refresh` micro iterations on it; a micro iteration solves for
    p (warm-started), line-searches on the fused energy+force evaluation
    and takes the accepted trial's forces as the next residual.

    `stats` (a dict) accumulates the counts newton_iters, hess_builds,
    cg_iters and ls_trials, appends each call's Newton iterations to
    newton_per_step and each Newton iteration's CG iterations to
    cg_per_newton (0 on the dense solve)."""
    if stats is not None:
        for k in ("newton_iters", "hess_builds", "cg_iters", "ls_trials"):
            stats.setdefault(k, 0)
        stats.setdefault("newton_per_step", [])
        stats.setdefault("cg_per_newton", [])

    x_hat = pos0 + vel * spec.dt + (
        spec.gravity + spec.ext_force / spec.mass[:, None]) * spec.dt**2
    start = torch.where(spec.frozen, pos0, x_hat)
    if max(1, spec.hess_refresh) == 1 or spec.solver == "dense":
        pos, it = _newton_full(spec, params, start, prev_pos, vel, ref_angle,
                               contact, stats)
    else:
        pos, it = _newton_modified(spec, params, start, prev_pos, vel,
                                   ref_angle, contact, stats)
    if stats is not None:
        stats["newton_per_step"].append(it)
    return pos


def _backtrack(spec, trial, E0, stats):
    """Halve alpha from 1 until trial(alpha)[0] < E0 or alpha falls to
    linesearch_min_alpha: (applied alpha, trial's outputs). On failure the
    last trial is the applied one (the JAX loop's alpha * 2)."""
    alpha = 1.0
    while True:
        out = trial(alpha)
        if stats is not None:
            stats["ls_trials"] += 1
        applied = alpha
        if bool(out[0] < E0):  # host sync
            return applied, out
        alpha *= 0.5
        if not alpha > spec.linesearch_min_alpha:
            return applied, out


def _newton_full(spec, params, start, prev_pos, vel, ref_angle, contact,
                 stats):
    """The full-Newton branch (JAX `cond`/`body`): (positions, iterations)."""
    pos = start
    E0 = elements.total_energy(spec, params, start, prev_pos, vel, ref_angle,
                               contact)
    it = 0
    delta = torch.tensor(1e5, dtype=start.dtype, device=start.device)
    p_prev = torch.zeros_like(start)
    while it < spec.max_newton_iter and bool(delta >= spec.newton_tol):
        groups = elements.all_groups(spec, params, pos, ref_angle, contact,
                                     with_hess=True, spd=True)
        F = elements.assemble_residual(spec, groups, pos, prev_pos, vel)
        p, n_cg = solve_linear(spec, groups, F, x0=p_prev, return_iters=True)
        delta = torch.amax(torch.abs(p)) / spec.dt
        E_of = elements.linesearch_energy_fn(spec, params, pos, p, prev_pos,
                                             vel, ref_angle, contact)
        applied, (E0,) = _backtrack(spec, lambda a: (E_of(a),), E0, stats)
        pos = pos - applied * p
        p_prev = p
        it += 1
        if stats is not None:
            stats["newton_iters"] += 1
            stats["hess_builds"] += 1
            stats["cg_iters"] += n_cg
            stats["cg_per_newton"].append(n_cg)
    return pos, it


def _newton_modified(spec, params, start, prev_pos, vel, ref_angle, contact,
                     stats):
    """The macro/micro modified-Newton branch: (positions, iterations)."""
    refresh = max(1, spec.hess_refresh)
    pos = start
    E0 = elements.total_energy(spec, params, start, prev_pos, vel, ref_angle,
                               contact)
    soups = elements.gather_soups(spec, contact, start)
    fg0 = elements.force_groups_from_soups(spec, params, soups, ref_angle,
                                           contact)
    F = elements.assemble_residual(spec, fg0, start, prev_pos, vel)
    it = 0
    delta = torch.tensor(1e5, dtype=start.dtype, device=start.device)
    p_prev = torch.zeros_like(start)

    def running():  # host sync
        return it < spec.max_newton_iter and bool(delta >= spec.newton_tol)

    while running():
        groups = elements.all_groups(spec, params, pos, ref_angle, contact,
                                     with_hess=True, spd=True)
        op = prepare_solver_state(spec, groups, pos.dtype)
        if stats is not None:
            stats["hess_builds"] += 1
        # the JAX micro loop masks its updates with cont = the outer loop's
        # condition; once it is false every later micro iteration (and the
        # macro loop) is a no-op, so it is a break here
        for _ in range(refresh):
            if not running():
                break
            p, n_cg = solve_cg_prepared(spec, op, F, return_iters=True,
                                        x0=p_prev)
            d_new = torch.amax(torch.abs(p)) / spec.dt
            dsoups = elements.gather_soups(spec, contact, p, direction=True)
            EF = elements.linesearch_ef_fn(spec, params, pos, p, prev_pos,
                                           vel, ref_angle, contact, soups,
                                           dsoups)
            applied, (E_new, g_new) = _backtrack(spec, EF, E0, stats)
            new_pos = pos - applied * p
            F = elements.assemble_residual(
                spec, {"idx": op["idx"], "g": g_new}, new_pos, prev_pos, vel)
            soups = {k: soups[k] - applied * dsoups[k] for k in soups}
            pos, E0, delta, p_prev = new_pos, E_new, d_new, p
            it += 1
            if stats is not None:
                stats["newton_iters"] += 1
                stats["cg_iters"] += n_cg
                stats["cg_per_newton"].append(n_cg)
    return pos, it
