"""Per-element scalar energy functions (counterpart of
`thinshelllab_tpu/ops/energies.py`; the reference definitions are listed
there).

Every function indexes its element axes from the right (`x[..., l, :]`), so
it evaluates one element or a whole soup at once: called on a batch it
returns one energy per element, and `torch.func.vmap(jacfwd(grad(f)))`
gives per-element Hessians. Cross products, norms and the 3x3 determinant
are written out elementwise, which keeps forward-over-reverse AD on plain
arithmetic.
"""
from __future__ import annotations

import numpy as np
import torch


def _cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.sqrt(torch.sum(a * a, dim=-1))


def _det3(F):
    return (F[..., 0, 0] * (F[..., 1, 1] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 1])
            - F[..., 0, 1] * (F[..., 1, 0] * F[..., 2, 2] - F[..., 1, 2] * F[..., 2, 0])
            + F[..., 0, 2] * (F[..., 1, 0] * F[..., 2, 1] - F[..., 1, 1] * F[..., 2, 0]))


# --------------------------------------------------------------------------
# Cloth membrane (per face, 9 coords)
# --------------------------------------------------------------------------


def membrane_energy(x, l0, rest_area, kl, ka):
    """x: (..., 3, 3) face vertex positions; edge l runs x[l] -> x[(l+1)%3]."""
    e_sum = 0.0
    for l in range(3):
        ln = _norm(x[..., l, :] - x[..., (l + 1) % 3, :])
        e_sum = e_sum + kl * (1.0 - ln / l0[..., l]) ** 2 * l0[..., l]
    n = _cross(x[..., 1, :] - x[..., 0, :], x[..., 2, :] - x[..., 0, :])
    # 0.5 as a tensor: with the Python float, jacfwd(grad) of a float32
    # face gives a float64 Hessian (see barrier_energy)
    area = _norm(n) * n.new_tensor(0.5)
    return e_sum + ka * (1.0 - area / rest_area) ** 2 * rest_area


# --------------------------------------------------------------------------
# Bending (per hinge, 12 coords)
# --------------------------------------------------------------------------


def hinge_angle(x, sel):
    """x: (..., 4, 3) = [v0, v1, v2, v3] hinge stencil; sel (..., 4, 4)
    one-hot rows picking (xa, xb, ea, eb) (see the JAX hinge_angle).
    theta = atan2((n1 x n2) . e_hat, n1 . n2). The selection is a broadcast
    multiply-reduce, exact for 0/1 entries."""
    rows = torch.sum(sel[..., :, :, None] * x[..., None, :, :], dim=-2)
    xa, xb, xea, xeb = (rows[..., k, :] for k in range(4))
    x0, x1, x2, x3 = (x[..., k, :] for k in range(4))
    n1 = _cross(x1 - x0, x2 - x1)
    n1 = n1 / _norm(n1)[..., None]
    n2 = _cross(xa - x3, xb - xa)
    n2 = n2 / _norm(n2)[..., None]
    e = xeb - xea
    ehat = e / _norm(e)[..., None]
    return torch.atan2(_dot(_cross(n1, n2), ehat), _dot(n1, n2))


def stencil_to_sel(ja, jb, ea, eb, dtype=np.float64):
    """The (4, 4) one-hot selection matrix (numpy) of stencil indices."""
    sel = np.zeros((4, 4), dtype)
    for r, i in enumerate((ja, jb, ea, eb)):
        sel[r, i] = 1.0
    return sel


def bending_energy(x, sel, ref_angle, coef, kb):
    """coef = dx^2 / 3 (reference model_fold_offset.py:120)."""
    theta = hinge_angle(x, sel)
    return kb * (theta - ref_angle) ** 2 * coef


def bending_energy_batch(x, sel, ref_angle, coef, kb):
    """Per-hinge bending energies over the whole soup at once: x (NH, 4, 3),
    sel (NH, 4, 4) -> (NH,), the JAX package's leading-axis-split form
    (`spec.bend_batch`). The 8 geometry rows (the 4 stencil vertices and
    the 4 sel-selected rows) come out of ONE broadcast multiply-reduce
    with the 0/1 rows [I; sel], stacked along a leading axis. Selecting
    with exact 0/1 factors is exact, so this agrees with bending_energy
    to rounding (the two forms order a few operations differently)."""
    eye = torch.eye(4, dtype=x.dtype, device=x.device).expand(sel.shape)
    sel8 = torch.cat([eye, sel.to(x.dtype)], dim=1)  # (NH, 8, 4)
    rows = torch.sum(sel8[:, :, :, None] * x[:, None, :, :],
                     dim=2).transpose(0, 1)  # (8, NH, 3): leading split
    x0, x1, x2, x3, xa, xb, xea, xeb = rows

    def _hat(v):
        return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))

    n1 = _hat(_cross(x1 - x0, x2 - x1))
    n2 = _hat(_cross(xa - x3, xb - xa))
    ehat = _hat(xeb - xea)
    theta = torch.atan2(torch.sum(_cross(n1, n2) * ehat, dim=-1),
                        torch.sum(n1 * n2, dim=-1))
    return kb * (theta - ref_angle) ** 2 * coef


# --------------------------------------------------------------------------
# Volumetric elastics (per tet, relative coords D: columns x_i - x_3)
# --------------------------------------------------------------------------


def neo_energy(D, B, W, mu, lam):
    F = torch.matmul(D, B)
    J = _det3(F)
    logJ = torch.log(torch.clamp(J, min=0.01))
    phi = (0.5 * mu * (torch.sum(F * F, dim=(-2, -1)) - 3.0) - mu * logJ
           + 0.5 * lam * logJ**2)
    return W * phi


def tactile_energy(D, B, W, mu, lam):
    F = torch.matmul(D, B)
    J = _det3(F)
    I1 = torch.sum(F * F, dim=(-2, -1))
    alpha = 1.0 + mu / lam
    phi = 0.5 * mu * (I1 - 3.0) + 0.5 * lam * (J - alpha) ** 2
    return W * phi


# --------------------------------------------------------------------------
# Contact barrier (relative coords: rows a = p1-p0, b = p2-p0, c = p-p0)
# --------------------------------------------------------------------------


def contact_gap(rel):
    """g = det(a,b,c)/|a x b|: signed distance of the projecting vertex
    from the triangle's plane."""
    ab = _cross(rel[..., 0, :], rel[..., 1, :])
    return _dot(ab, rel[..., 2, :]) / _norm(ab)


def barrier_energy(rel, k_contact, eps_contact):
    g = contact_gap(rel)
    # written so that no Python float meets a function of the input before
    # the last product: under jacfwd(grad), (g - 4e-4) ** 2 and
    # 5000.0 * g * g of a float32 g both come out as float64 Hessians
    d = g - g.new_tensor(eps_contact)
    e = (d * d) * (0.5 * k_contact)
    return torch.where(g < eps_contact, e, torch.zeros_like(e))


# --------------------------------------------------------------------------
# Friction mollifier
# --------------------------------------------------------------------------


def f0_smooth(x, eps_v, h):
    """Reference BaseScene.f0:453-460 mollifier of |u|."""
    eh = eps_v * h
    quad = -(x**3) / (3.0 * eh * eh) + x * x / eh + eh / 3.0
    return torch.where(x > eh, x, quad)


# --------------------------------------------------------------------------
# Inertia + external (per vertex; quadratic)
# --------------------------------------------------------------------------


def inertia_external_energy(pos, prev_pos, vel, mass, gravity, ext_force, dt):
    """sum_i [ 0.5 m |x - x_prev - v dt|^2 / dt^2 - (m g + f_ext) . x ]."""
    X = pos - prev_pos - vel * dt
    e_inertia = 0.5 * torch.sum(mass * torch.sum(X * X, dim=-1)) / dt**2
    f = mass[:, None] * gravity + ext_force
    return e_inertia - torch.sum(f * pos)
