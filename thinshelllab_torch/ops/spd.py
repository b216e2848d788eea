"""Batched PSD-ification of small symmetric blocks (counterpart of
`thinshelllab_tpu/ops/spd.py`, the parts the forward Newton solve runs)."""
from __future__ import annotations

import torch


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
    raise NotImplementedError(
        f"spd_method={method!r}: the eigenvalue-clamp projection is not "
        "ported yet; the bench scene uses 'shift'")


def value_grad_hess(energy_fn, argnum: int = 0):
    """f(*args) -> (E, dE/dx, d2E/dx2) for a scalar energy of one element;
    the Hessian is forward-over-reverse (jacfwd of grad). Wrap the result in
    torch.func.vmap for a batch of elements."""
    grad_fn = torch.func.grad(energy_fn, argnums=argnum)
    hess_fn = torch.func.jacfwd(grad_fn, argnums=argnum)

    def f(*args):
        return energy_fn(*args), grad_fn(*args), hess_fn(*args)

    return f
