"""Batched PSD-ification of small symmetric blocks and the closed-form
|D|^-1 of the adjoint preconditioner (counterpart of
`thinshelllab_tpu/ops/spd.py`)."""
from __future__ import annotations

import torch


def project_psd(H):
    """H: (..., k, k) symmetric -> nearest PSD (eigenvalue clamp): the
    symmetrised blocks' batched `torch.linalg.eigh`, negative eigenvalues
    set to 0, reassembled. The clamped projection is unique even where
    the eigenvectors are not (repeated eigenvalues)."""
    Hs = 0.5 * (H + H.transpose(-1, -2))
    w, v = _eigh(Hs)
    w = torch.clamp(w, min=0.0)
    return torch.einsum("...ik,...k,...jk->...ij", v, w, v)


def _eigh(Hs):
    """`torch.linalg.eigh` on the blocks' own device; float32 blocks are
    decomposed in float64 and the result cast back. In float32 cuSOLVER's
    batched Jacobi solver refused ill-conditioned 9x9 element Hessians of
    lifting and sliding, and in a long process returned NaN for the
    all-zero blocks of finite 12x12 batches without raising (PERF.md,
    `scripts/probe_eigh_fault.py`); a float64 batch of the self-contact
    hairpin failed the same way late in a long process. An all-zero block
    is decomposed exactly (eigenvalues 0, eigenvectors I) without the
    solver. A refusal, or a non-finite result, for finite blocks raises;
    non-finite blocks give NaN, as the JAX package's eigh does."""
    H = Hs.double() if Hs.dtype == torch.float32 else Hs
    k = H.shape[-1]
    zero = ~H.reshape(*H.shape[:-2], k * k).any(dim=-1)
    eye = torch.eye(k, dtype=H.dtype, device=H.device)
    try:
        w, v = torch.linalg.eigh(torch.where(zero[..., None, None], eye, H))
        bad = ~(torch.isfinite(w).all(dim=-1)
                & torch.isfinite(v).all(dim=(-1, -2)))
        ok = not bool(bad.any())
    except torch.linalg.LinAlgError as e:
        ok, bad = False, str(e).splitlines()[0]
    if not ok:
        if bool(torch.isfinite(H).all()):
            what = (f"{int(bad.sum())} blocks with a non-finite result"
                    if isinstance(bad, torch.Tensor) else f"refused: {bad}")
            raise torch.linalg.LinAlgError(
                f"eigh failed on a finite {H.dtype} batch of shape "
                f"{tuple(H.shape)} on {H.device} ({what})")
        nan = torch.full_like(Hs, float("nan"))
        return nan[..., 0], nan
    w = torch.where(zero[..., None], torch.zeros_like(w), w)
    v = torch.where(zero[..., None, None], eye, v)
    return w.to(Hs.dtype), v.to(Hs.dtype)


def project_psd_2x2(H):
    """Closed-form 2x2 PSD projection (reference linalg.SPD_project_2d:6-12):
    symmetric eigen-decomposition with negative eigenvalues clamped."""
    a = H[..., 0, 0]
    b = 0.5 * (H[..., 0, 1] + H[..., 1, 0])
    c = H[..., 1, 1]
    tr = a + c
    det_s = torch.sqrt(torch.clamp(((a - c) * 0.5) ** 2 + b * b, min=0.0))
    l1 = 0.5 * tr + det_s
    l2 = 0.5 * tr - det_s
    # eigenvector for l1: (b, l1 - a) unless degenerate
    tiny = torch.finfo(H.dtype).tiny
    nondeg = torch.abs(b) > tiny
    vx = torch.where(nondeg, b, torch.ones_like(b))
    vy = torch.where(nondeg, l1 - a, torch.zeros_like(b))
    nrm = torch.sqrt(vx * vx + vy * vy)
    vx, vy = vx / nrm, vy / nrm
    l1c = torch.clamp(l1, min=0.0)
    l2c = torch.clamp(l2, min=0.0)
    off = (l1c - l2c) * vx * vy
    return torch.stack(
        [
            torch.stack([l1c * vx * vx + l2c * vy * vy, off], -1),
            torch.stack([off, l1c * vy * vy + l2c * vx * vx], -1),
        ],
        dim=-2,
    )


def gershgorin_psd(H):
    """H + max(0, -lambda_lb) I with the Gershgorin lower bound
    lambda_lb = min_i (H_ii - sum_{j!=i} |H_ij|), on the symmetrised H.
    Keeps the Newton direction a descent direction at elementwise cost."""
    Hs = 0.5 * (H + H.transpose(-1, -2))
    k = Hs.shape[-1]
    diag = torch.diagonal(Hs, dim1=-2, dim2=-1)
    offsum = torch.sum(torch.abs(Hs), dim=-1) - torch.abs(diag)
    lam_lb = torch.amin(diag - offsum, dim=-1)
    shift = torch.clamp(-lam_lb, min=0.0)
    eye = torch.eye(k, dtype=H.dtype, device=H.device)
    return Hs + shift[..., None, None] * eye


def project_psd_method(H, method: str):
    if method == "shift":
        return gershgorin_psd(H)
    return project_psd(H)


def _eigvals_sym3(D):
    """Closed-form (trigonometric Cardano) eigenvalues of batched symmetric
    3x3 blocks, ascending: shift by the trace mean q, scale by
    p = sqrt(tr((D - qI)^2) / 6), and the eigenvalues of the normalised
    B = (D - qI) / p are 2 cos((acos(det(B)/2) + 2 pi k) / 3)."""
    a, b, c = D[..., 0, 0], D[..., 1, 1], D[..., 2, 2]
    d, e, f = D[..., 0, 1], D[..., 1, 2], D[..., 0, 2]
    q = (a + b + c) / 3.0
    p2 = ((a - q) ** 2 + (b - q) ** 2 + (c - q) ** 2
          + 2.0 * (d * d + e * e + f * f))
    tiny = torch.finfo(D.dtype).tiny
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=tiny))
    a_, b_, c_ = (a - q) / p, (b - q) / p, (c - q) / p
    d_, e_, f_ = d / p, e / p, f / p
    detB = (a_ * (b_ * c_ - e_ * e_) - d_ * (d_ * c_ - e_ * f_)
            + f_ * (d_ * e_ - b_ * f_))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    # p2 ~ 0 (scalar matrix): all eigenvalues are q exactly
    scalar = p2 <= 6.0 * tiny
    lam_hi = torch.where(scalar, q, lam_hi)
    lam_mid = torch.where(scalar, q, lam_mid)
    lam_lo = torch.where(scalar, q, lam_lo)
    return torch.stack([lam_lo, lam_mid, lam_hi], dim=-1)


def abs_inv_3x3(D, floor_rel=1e-6):
    """Batched |D|^-1 of symmetric 3x3 blocks without an eigenvector solve:
    f(D) with f(lam) = 1 / max(|lam|, floor) is a degree-2 polynomial in D
    (Cayley-Hamilton), built from the closed-form eigenvalues by Newton
    divided differences,

        f(D) = f(l1) I + f[l1,l2] (D - l1 I)
               + f[l1,l2,l3] (D - l1 I)(D - l2 I),

    with guarded (sign-preserving) denominators where eigenvalues cluster.
    The block-Jacobi part of the adjoint GMRES preconditioner."""
    dt = D.dtype
    Ds = 0.5 * (D + D.transpose(-1, -2))
    lam = _eigvals_sym3(Ds)
    mx = torch.amax(torch.abs(lam), dim=-1, keepdim=True)
    tiny = torch.finfo(dt).tiny
    floor = floor_rel * mx + tiny
    fl = 1.0 / torch.maximum(torch.abs(lam), floor)
    l1, l2, l3 = lam[..., 0], lam[..., 1], lam[..., 2]
    f1, f2, f3 = fl[..., 0], fl[..., 1], fl[..., 2]
    gscale = torch.finfo(dt).eps * mx[..., 0] + tiny

    def _gdiv(num, den):
        mag = torch.maximum(torch.abs(den), gscale)
        return num / torch.where(den < 0, -mag, mag)

    c1 = _gdiv(f2 - f1, l2 - l1)
    c2 = _gdiv(_gdiv(f3 - f2, l3 - l2) - c1, l3 - l1)
    eye = torch.eye(3, dtype=dt, device=D.device)
    M1 = Ds - l1[..., None, None] * eye
    M2 = Ds - l2[..., None, None] * eye
    out = (f1[..., None, None] * eye + c1[..., None, None] * M1
           + c2[..., None, None] * torch.matmul(M1, M2))
    return 0.5 * (out + out.transpose(-1, -2))


def value_grad_hess(energy_fn, argnum: int = 0):
    """f(*args) -> (E, dE/dx, d2E/dx2) for a scalar energy of one element;
    the Hessian is forward-over-reverse (jacfwd of grad). Wrap the result in
    torch.func.vmap for a batch of elements."""
    grad_fn = torch.func.grad(energy_fn, argnums=argnum)
    hess_fn = torch.func.jacfwd(grad_fn, argnums=argnum)

    def f(*args):
        return energy_fn(*args), grad_fn(*args), hess_fn(*args)

    return f
