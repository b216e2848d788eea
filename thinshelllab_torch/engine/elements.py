"""Element evaluation and assembly for the forward Newton solve and the
adjoint (counterpart of `thinshelllab_tpu/engine/elements.py`: the DIA
paths of the bench and the dense assembly of small scenes).

Each evaluation produces a "group": a dict with
    idx: (E, k) global vertex ids
    g:   (E, k, 3) per-element energy gradient (zeroed when inactive)
    H:   (E, k, k, 3, 3) element Hessian blocks H[e,a,b] = d2E/dx_a dx_b
Gradients come from `torch.func.grad_and_value` of the soup's summed
energy (per-element gradients, as `vmap(grad)` gives them) and Hessians
from `vmap(jacfwd(grad))`, except the closed-form membrane Hessian.

The operator is the hybrid DIA layout of the JAX package: a static
(n_off, 3, 3, NVp) store applied by the `dia_spmv` kernel, the leftover
pull slots, and the dynamic contact part (frozen-source diagonal +
selection-matmul pairs). The forward CG state lives in the transposed
(3, NVp) layout (`*_T`); the adjoint GMRES applies the same operator to
(NV, 3) vectors (`hvp_dia`). A CG scene without a DIA plan (a cloth too
narrow for one) applies the pull operator (`hvp_pull`: the static blocks
gathered per row, the contact blocks scattered); the dense solve of small
scenes assembles the whole matrix (`dense_hessian`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tF

from ..core.spec import ContactSet, DeviceConsts, SceneSpec
from ..ops import dia_spmv as _spmv
from ..ops import element_kernels as _ek
from ..ops import energies as en
from ..ops.spd import project_psd_2x2, project_psd_method
from . import gridsolve
from .plans import (  # noqa: F401  (the JAX module's planner names)
    build_dia_plan,
    build_hvp_slots,
    contact_static_split,
    static_block_count,
)

_vmap, _jacfwd, _grad = torch.func.vmap, torch.func.jacfwd, torch.func.grad

# masked-out hinges are evaluated on this non-degenerate stencil so NaNs
# never enter the masked terms (the mask does not stop NaN gradients)
_CANON_STENCIL = np.array(
    [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [-1.0, 1.0, 0.3]]
)


def device_consts(host: SceneSpec, spec: SceneSpec) -> DeviceConsts:
    """The loop-invariant tensors of a moved spec (`spec`), made once from
    it and from the builder's numpy spec (`host`)."""
    dt, dev = spec.dtype, spec.mass.device
    unf = (~spec.frozen).to(dt)
    kw = dict(
        unf=unf,
        unf_p=torch.cat([unf, unf.new_zeros((1, 3))]),
        canon=torch.as_tensor(_CANON_STENCIL, dtype=dt, device=dev),
        hinge_m=spec.cloth.hinge_mask.to(dt),
        # the card takes the gather/scatter path for every non-diagonal pair
        contact_split=contact_static_split(host, mm=dev.type != "cuda"),
    )
    plan = spec.dia
    if plan is not None:
        unf2, m2 = t2_consts(spec, dt)
        masks = []
        for (N, M, *_rest) in plan.cloths:
            ii, jj = np.meshgrid(np.arange(N), np.arange(M), indexing="ij")
            par = (ii + jj) % 2
            masks.append(torch.as_tensor(np.stack([par == 0, par == 1]),
                                         dtype=dt, device=dev))
        n_off = len(plan.offsets)
        gp = gridsolve.build_grid_plan(host)
        kw.update(
            grid_plan=tuple(gp),
            coupling_slots=tuple(
                None if s is None else torch.as_tensor(s, device=dev)
                for s in gridsolve.contact_coupling_slots(host, gp)),
            unf2=unf2, m2=m2,
            offsets_t=torch.as_tensor(plan.offsets, dtype=torch.int32,
                                      device=dev),
            off0=plan.offsets.index(0),
            par_masks=tuple(masks),
            onehot=(tF.one_hot(plan.o_idx, n_off + 1).to(dt)
                    if plan.rows.shape[0] else None),
        )
    return DeviceConsts(**kw)


# --------------------------------------------------------------------------
# shape-matrix helpers (exact slicing/sums, as in the JAX package)
# --------------------------------------------------------------------------


def _tet_D(x):
    """D[t, i, j] = x[t, j, i] - x[t, 3, i]."""
    return (x[:, :3] - x[:, 3:4]).transpose(1, 2)


def _tet_g(G):
    """g[t, a] = G[t, :, a] for a < 3, minus their sum for a = 3."""
    Gt = G.transpose(1, 2)
    return torch.cat([Gt, -Gt.sum(dim=1, keepdim=True)], dim=1)


def _tet_H(Hd):
    """H[t,a,b,i,k] = sum_jl Hd[t,i,j,k,l] S[a,j] S[b,l]."""
    A = Hd.permute(0, 2, 4, 1, 3)
    A = torch.cat([A, -A.sum(dim=1, keepdim=True)], dim=1)
    return torch.cat([A, -A.sum(dim=2, keepdim=True)], dim=2)


def _rel_R(x):
    """R[c, r] = x[c, r+1] - x[c, 0]."""
    return x[:, 1:] - x[:, :1]


def _rel_g(G):
    return torch.cat([-G.sum(dim=1, keepdim=True), G], dim=1)


def _rel_H(Hr):
    A = Hr.permute(0, 1, 3, 2, 4)
    A = torch.cat([-A.sum(dim=1, keepdim=True), A], dim=1)
    return torch.cat([-A.sum(dim=2, keepdim=True), A], dim=2)


def _energies_and_grads(fn, x, *args):
    """Per-element energies of a batched energy fn and their gradients
    with respect to x (one backward pass of the summed energy)."""
    def total(x_):
        e = fn(x_, *args)
        return e.sum(), e

    g, (_tot, e) = torch.func.grad_and_value(total, has_aux=True)(x)
    return e, g


def _elem_hessians(fn, x, *args):
    """Per-element d2E/dx2 by forward-over-reverse AD."""
    return _vmap(_jacfwd(_grad(fn)))(x, *args)


def _spd(H, k, spd_method):
    """PSD-ify (E, ...) blocks viewed as (E, k, k)."""
    return project_psd_method(H.reshape(-1, k, k), spd_method)


# --------------------------------------------------------------------------
# per-soup energy evaluation
# --------------------------------------------------------------------------


def _face_params(spec, params):
    return (params.kl[spec.cloth.cloth_id], params.ka[spec.cloth.cloth_id])


def _skew(v):
    """(..., 3) -> (..., 3, 3) with skew(v) @ w = v x w."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], -1),
            torch.stack([v[..., 2], z, -v[..., 0]], -1),
            torch.stack([-v[..., 1], v[..., 0], z], -1),
        ],
        -2,
    )


def membrane_hess_closed(x, l0, rest_area, kl, ka):
    """Exact closed-form membrane Hessian blocks (E, 3, 3, 3, 3), layout
    H[e, a, b] = d2E/dx_a dx_b (the derivation is in the JAX docstring)."""
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    H = x.new_zeros((x.shape[0], 3, 3, 3, 3))
    for l_ in range(3):
        a, b = l_, (l_ + 1) % 3
        d = x[:, a] - x[:, b]
        ln = torch.sqrt(torch.sum(d * d, dim=1))
        dh = d / ln[:, None]
        P = dh[:, :, None] * dh[:, None, :]
        spp = (2.0 * kl / l0[:, l_])[:, None, None]
        spl = ((-2.0 * kl * (1.0 - ln / l0[:, l_])) / ln)[:, None, None]
        Hd = spp * P + spl * (eye - P)
        H[:, a, a] += Hd
        H[:, b, b] += Hd
        H[:, a, b] -= Hd
        H[:, b, a] -= Hd

    c1 = x[:, 1] - x[:, 0]
    c2 = x[:, 2] - x[:, 0]
    n = en._cross(c1, c2)
    nn = en._norm(n)
    nh = n / nn[:, None]
    A = 0.5 * nn
    p1 = (-2.0 * ka * (1.0 - A / rest_area))[:, None, None]  # p'
    p2 = (2.0 * ka / rest_area)[:, None, None]               # p''
    g1 = 0.5 * en._cross(c2, nh)
    g2 = 0.5 * en._cross(nh, c1)
    P = eye - nh[:, :, None] * nh[:, None, :]
    S1, S2, Sn = _skew(c1), _skew(c2), _skew(nh)
    inv2n = (0.5 / nn)[:, None, None]
    PS1 = torch.bmm(P, S1)
    PS2 = torch.bmm(P, S2)
    K11 = -torch.bmm(S2, PS2) * inv2n
    K12 = torch.bmm(S2, PS1) * inv2n
    K22 = -torch.bmm(S1, PS1) * inv2n
    C11 = p2 * g1[:, :, None] * g1[:, None, :] + p1 * K11
    C12 = p2 * g1[:, :, None] * g2[:, None, :] + p1 * (K12 - 0.5 * Sn)
    C22 = p2 * g2[:, :, None] * g2[:, None, :] + p1 * K22
    C21 = C12.transpose(-1, -2)
    H[:, 1, 1] += C11
    H[:, 1, 2] += C12
    H[:, 2, 1] += C21
    H[:, 2, 2] += C22
    H[:, 0, 1] -= C11 + C21
    H[:, 0, 2] -= C12 + C22
    H[:, 1, 0] -= C11 + C12
    H[:, 2, 0] -= C21 + C22
    H[:, 0, 0] += C11 + C12 + C21 + C22
    return H


def membrane_eval(spec, params, pos, with_hess: bool, spd: bool):
    c = spec.cloth
    x = pos[c.f2v]  # (E, 3, 3)
    kl, ka = _face_params(spec, params)
    E, g = _energies_and_grads(en.membrane_energy, x, c.l0, c.rest_area,
                               kl, ka)
    out = {"idx": c.f2v, "g": g}
    if with_hess:
        H = membrane_hess_closed(x, c.l0, c.rest_area, kl, ka)
        if spd:
            H9 = _spd(H.permute(0, 1, 3, 2, 4), 9, spec.spd_method)
            H = H9.reshape(-1, 3, 3, 3, 3).permute(0, 1, 3, 2, 4)
        out["H"] = H
    return E.sum(), out


def bending_eval(spec, params, pos, ref_angle, with_hess: bool, spd: bool):
    c = spec.cloth
    x = torch.where(c.hinge_mask[:, None, None], pos[c.hinge_verts],
                    spec.dev.canon)
    E, g = bending_soup_eg(spec, params, x, ref_angle)
    out = {"idx": c.hinge_verts, "g": g}
    if with_hess:
        kb = params.kb[c.hinge_cloth]
        H = _elem_hessians(en.bending_energy, x, c.hinge_sel, ref_angle,
                           c.hinge_coef, kb)  # (NH, 4, 3, 4, 3)
        H = H.permute(0, 1, 3, 2, 4) * spec.dev.hinge_m[:, None, None, None,
                                                         None]
        if spd:
            H12 = _spd(H.permute(0, 1, 3, 2, 4), 12, spec.spd_method)
            H = H12.reshape(-1, 4, 3, 4, 3).permute(0, 1, 3, 2, 4)
        out["H"] = H
    return E, out


def _tet_eval(energy, soup, mu_arr, lam_arr, pos, with_hess: bool, spd: bool,
              spd_method: str):
    D = _tet_D(pos[soup.tets])
    mu = mu_arr[soup.group]
    lam = lam_arr[soup.group]
    E, G = _energies_and_grads(energy, D, soup.B, soup.W, mu, lam)
    out = {"idx": soup.tets, "g": _tet_g(G)}
    if with_hess:
        Hd = _elem_hessians(energy, D, soup.B, soup.W, mu, lam)
        if spd:
            Hd = _spd(Hd, 9, spd_method).reshape(-1, 3, 3, 3, 3)
        out["H"] = _tet_H(Hd)
    return E.sum(), out


def neo_eval(spec, params, pos, with_hess, spd):
    return _tet_eval(en.neo_energy, spec.neo, params.neo_mu, params.neo_lam,
                     pos, with_hess, spd, spec.spd_method)


def tact_eval(spec, params, pos, with_hess, spd):
    return _tet_eval(en.tactile_energy, spec.tact, params.tact_mu,
                     params.tact_lam, pos, with_hess, spd, spec.spd_method)


def _barrier_fn(spec):
    k, eps = spec.k_contact, spec.eps_contact
    return lambda Rm: en.barrier_energy(Rm, k, eps)


def barrier_eval(spec, contact: ContactSet, pos, with_hess: bool, spd: bool):
    R = _rel_R(pos[contact.idx])
    fn = _barrier_fn(spec)
    E, G = _energies_and_grads(fn, R)
    m = contact.active.to(pos.dtype)
    out = {"idx": contact.idx, "g": _rel_g(G) * m[:, None, None]}
    if with_hess:
        Hr = _elem_hessians(fn, R)  # (C, 3,3,3,3): (r,i,s,k)
        if spd:
            Hr = _spd(Hr, 9, spec.spd_method).reshape(-1, 3, 3, 3, 3)
        out["H"] = _rel_H(Hr) * m[:, None, None, None, None]
    return torch.sum(E * m), out


def friction_slip(spec, contact: ContactSet, xc):
    """Tangential slip u (C, 2) of the gathered contact soup and its guarded
    norm r = sqrt(|u|^2 + tiny) (u is exactly zero at the build state)."""
    xcen = torch.einsum("ck,cki->ci", contact.w, xc[:, :3])
    dx = xc[:, 3] - xcen - contact.dx0
    u = torch.einsum("cti,ci->ct", contact.T, dx)
    r = torch.sqrt(torch.sum(u * u, dim=1) + torch.finfo(u.dtype).tiny)
    return u, r


def friction_f1(spec, r):
    """f1 = f0' / r of the smoothed Coulomb magnitude (BaseScene.py:548)."""
    eh = spec.eps_v * spec.dt
    tiny = torch.finfo(r.dtype).tiny
    return torch.where(r > eh, 1.0 / torch.clamp(r, min=tiny),
                       -r / eh**2 + 2.0 / eh)


def _friction_w1(w):
    return torch.cat([-w, w.new_ones((w.shape[0], 1))], dim=1)


def _friction_force_rows(spec, contact: ContactSet, xc, u, r):
    """Masked per-element force rows (C, 4, 3) from precomputed slip."""
    f1 = friction_f1(spec, r)
    g_u = u * (contact.k * f1)[:, None]
    g1 = torch.einsum("ct,cti->ci", g_u, contact.T)
    w1 = _friction_w1(contact.w)
    m = contact.active.to(xc.dtype)
    return w1[:, :, None] * g1[:, None, :] * m[:, None, None]


def friction_eval(spec, contact: ContactSet, pos, with_hess: bool, spd: bool):
    """Smoothed Coulomb friction (reference BaseScene.py:548-595), closed
    form: g = k f1(r) T^T u, H = w1 w1^T (x) k T^T h T with
    h = f1(r) I + (f1'(r)/r) u u^T; only h (2x2) is SPD-projected."""
    x = pos[contact.idx]
    eh = spec.eps_v * spec.dt
    u, r = friction_slip(spec, contact, x)
    f1 = friction_f1(spec, r)
    E = contact.k * en.f0_smooth(r, spec.eps_v, spec.dt)
    m = contact.active.to(pos.dtype)
    out = {"idx": contact.idx,
           "g": _friction_force_rows(spec, contact, x, u, r)}
    if with_hess:
        tiny = torch.finfo(r.dtype).tiny
        w1 = _friction_w1(contact.w)
        f1p = torch.where(r > eh, -1.0 / torch.clamp(r, min=tiny) ** 2,
                          torch.full_like(r, -1.0 / eh**2))
        uu = torch.einsum("ct,cs->cts", u, u)
        # the reference drops the outer-product term for r <= 1e-9
        coef = torch.where(r > 1e-9, f1p / torch.clamp(r, min=1e-9),
                           torch.zeros_like(r))
        eye2 = torch.eye(2, dtype=pos.dtype, device=pos.device)
        h = f1[:, None, None] * eye2 + coef[:, None, None] * uu
        if spd:
            h = project_psd_2x2(h)
        h1 = contact.k[:, None, None] * torch.einsum(
            "cti,cts,csj->cij", contact.T, h, contact.T)
        H = torch.einsum("ca,cb,cij->cabij", w1, w1, h1)
        out["H"] = H * m[:, None, None, None, None]
    return torch.sum(E * m), out


# --------------------------------------------------------------------------
# Totals and fused groups
# --------------------------------------------------------------------------


def total_energy(spec, params, pos, prev_pos, vel, ref_angle, contact):
    e = en.inertia_external_energy(pos, prev_pos, vel, spec.mass,
                                   spec.gravity, spec.ext_force, spec.dt)
    e_m, _ = membrane_eval(spec, params, pos, False, False)
    e_b, _ = bending_eval(spec, params, pos, ref_angle, False, False)
    e = e + e_m + e_b
    if spec.neo.tets.shape[0]:
        e = e + neo_eval(spec, params, pos, False, False)[0]
    if spec.tact.tets.shape[0]:
        e = e + tact_eval(spec, params, pos, False, False)[0]
    e_c, _ = barrier_eval(spec, contact, pos, False, False)
    e_f, _ = friction_eval(spec, contact, pos, False, False)
    return e + e_c + e_f


def bending_soup_eg(spec, params, xb, ref_angle):
    """Bending energy sum + masked per-hinge gradients of the gathered hinge
    soup (NH, 4, 3). spec.bend_batch (TSL_BEND_BATCH=1 at scene build)
    takes the JAX package's batch form: bending_energy_batch, its gradient
    the vector-Jacobian product with the 0/1 hinge mask as the cotangent
    (torch.func.vjp, so that autograd through the gradient, as the
    parameter gradient takes it, still works). The two forms agree to
    rounding; every path of one spec takes the same form."""
    c = spec.cloth
    kb = params.kb[c.hinge_cloth]
    m = spec.dev.hinge_m
    if spec.bend_batch:
        eb, vjp = torch.func.vjp(
            lambda xx: en.bending_energy_batch(xx, c.hinge_sel, ref_angle,
                                               c.hinge_coef, kb), xb)
        (gb,) = vjp(m)
        return torch.sum(eb * m), gb
    eb, gb = _energies_and_grads(en.bending_energy, xb, c.hinge_sel,
                                 ref_angle, c.hinge_coef, kb)
    return torch.sum(eb * m), gb * m[:, None, None]


def _tet_parts(spec, params, soups, dsoups):
    parts = []
    for key, soup, mu_arr, lam_arr, efn in (
        ("xn", spec.neo, params.neo_mu, params.neo_lam, en.neo_energy),
        ("xt", spec.tact, params.tact_mu, params.tact_lam, en.tactile_energy),
    ):
        if soup.tets.shape[0]:
            parts.append((soup, mu_arr[soup.group], lam_arr[soup.group], efn,
                          soups[key], dsoups[key]))
    return parts


def linesearch_energy_fn(spec, params, pos, p, prev_pos, vel, ref_angle,
                         contact, soups=None, dsoups=None):
    """E_of(alpha) = total_energy(pos - alpha p), term by term (the same
    masks, canonical stencil on masked-out hinges and friction guard), on
    soups gathered once: gathering commutes with the affine step, so a
    trial gathers nothing. soups/dsoups: gather_soups of pos and of p
    (direction=True), gathered here when not given."""
    c = spec.cloth
    kl, ka = _face_params(spec, params)
    kb = params.kb[c.hinge_cloth]
    if soups is None:
        soups = gather_soups(spec, contact, pos)
    if dsoups is None:
        dsoups = gather_soups(spec, contact, p, direction=True)
    xm, dm = soups["xm"], dsoups["xm"]
    xb, db = soups["xb"], dsoups["xb"]
    xc, dc = soups["xc"], dsoups["xc"]
    tets = _tet_parts(spec, params, soups, dsoups)
    mb = spec.dev.hinge_m
    mC = contact.active.to(pos.dtype)
    bar = _barrier_fn(spec)
    bend = en.bending_energy_batch if spec.bend_batch else en.bending_energy

    def E_of(alpha):
        e = en.inertia_external_energy(pos - alpha * p, prev_pos, vel,
                                       spec.mass, spec.gravity,
                                       spec.ext_force, spec.dt)
        e = e + torch.sum(en.membrane_energy(xm - alpha * dm, c.l0,
                                             c.rest_area, kl, ka))
        eb = bend(xb - alpha * db, c.hinge_sel, ref_angle, c.hinge_coef, kb)
        e = e + torch.sum(eb * mb)
        for soup, mu, lam, efn, xt, dt_ in tets:
            e = e + torch.sum(efn(_tet_D(xt - alpha * dt_), soup.B, soup.W,
                                  mu, lam))
        xc_ = xc - alpha * dc
        e = e + torch.sum(bar(_rel_R(xc_)) * mC)
        _u, r = friction_slip(spec, contact, xc_)
        eF = contact.k * en.f0_smooth(r, spec.eps_v, spec.dt)
        return e + torch.sum(eF * mC)

    return E_of


def linesearch_ef_fn(spec, params, pos, p, prev_pos, vel, ref_angle,
                     contact, soups, dsoups):
    """EF_of(alpha) -> (E, g_fused): the line-search energy at pos - alpha p
    and the fused (E4, 4, 3) force-group gradient there, both from the
    pre-gathered soups (gathering commutes with the affine step). The
    accepted trial's gradient is the next Newton iteration's residual."""
    c = spec.cloth
    kl, ka = _face_params(spec, params)
    kb = params.kb[c.hinge_cloth]
    xm, dm = soups["xm"], dsoups["xm"]
    xb, db = soups["xb"], dsoups["xb"]
    xc, dc = soups["xc"], dsoups["xc"]
    tets = _tet_parts(spec, params, soups, dsoups)
    mC = contact.active.to(pos.dtype)
    bar = _barrier_fn(spec)

    def EF_of(alpha):
        gs = []
        e = en.inertia_external_energy(pos - alpha * p, prev_pos, vel,
                                       spec.mass, spec.gravity,
                                       spec.ext_force, spec.dt)
        em, gm = _energies_and_grads(en.membrane_energy, xm - alpha * dm,
                                     c.l0, c.rest_area, kl, ka)
        e = e + torch.sum(em)
        gs.append(gm)
        e_b, gb = bending_soup_eg(spec, params, xb - alpha * db, ref_angle)
        e = e + e_b
        gs.append(gb)
        for soup, mu, lam, efn, xt, dt_ in tets:
            et, G = _energies_and_grads(efn, _tet_D(xt - alpha * dt_),
                                        soup.B, soup.W, mu, lam)
            e = e + torch.sum(et)
            gs.append(_tet_g(G))
        xc_ = xc - alpha * dc
        eC, Gb = _energies_and_grads(bar, _rel_R(xc_))
        e = e + torch.sum(eC * mC)
        g_bar = _rel_g(Gb) * mC[:, None, None]
        u, r = friction_slip(spec, contact, xc_)
        eF = contact.k * en.f0_smooth(r, spec.eps_v, spec.dt)
        e = e + torch.sum(eF * mC)
        gs.append(g_bar + _friction_force_rows(spec, contact, xc_, u, r))
        # fuse in the family order and padding of fuse_groups
        return e, torch.cat([_pad_rows(g, 4) for g in gs])

    return EF_of


def _pad_rows(g, k):
    if g.shape[1] == k:
        return g
    return torch.cat([g, g.new_zeros((g.shape[0], k - g.shape[1], 3))], dim=1)


def gather_soups(spec, contact, v, direction=False):
    """Every element family's stencil values of a global (NV, 3) vector,
    gathered once. Soups are affine in v, so
    gather_soups(pos - a p) == gather_soups(pos) - a gather_soups(p, True)
    exactly. direction=False puts the canonical stencil on masked-out
    hinges; direction=True zeroes them so the identity keeps it."""
    c = spec.cloth
    out = {"xm": v[c.f2v]}
    hv = v[c.hinge_verts]
    mask = c.hinge_mask[:, None, None]
    out["xb"] = (torch.where(mask, hv, torch.zeros_like(hv)) if direction
                 else torch.where(mask, hv, spec.dev.canon))
    if spec.neo.tets.shape[0]:
        out["xn"] = v[spec.neo.tets]
    if spec.tact.tets.shape[0]:
        out["xt"] = v[spec.tact.tets]
    out["xc"] = v[contact.idx]
    return out


def force_groups_from_soups(spec, params, soups, ref_angle, contact):
    """The fused force-only group (all_groups with_hess=False) from
    pre-gathered soups, with the masks and guards of each *_eval."""
    c = spec.cloth
    kl, ka = _face_params(spec, params)
    groups = []
    _, gm = _energies_and_grads(en.membrane_energy, soups["xm"], c.l0,
                                c.rest_area, kl, ka)
    groups.append({"idx": c.f2v, "g": gm})
    _, gb = bending_soup_eg(spec, params, soups["xb"], ref_angle)
    groups.append({"idx": c.hinge_verts, "g": gb})
    for soup, mu, lam, efn, xt, _d in _tet_parts(spec, params, soups, soups):
        _, G = _energies_and_grads(efn, _tet_D(xt), soup.B, soup.W, mu, lam)
        groups.append({"idx": soup.tets, "g": _tet_g(G)})
    _, Gb = _energies_and_grads(_barrier_fn(spec), _rel_R(soups["xc"]))
    mC = contact.active.to(soups["xc"].dtype)
    u, r = friction_slip(spec, contact, soups["xc"])
    g = (_rel_g(Gb) * mC[:, None, None]
         + _friction_force_rows(spec, contact, soups["xc"], u, r))
    groups.append({"idx": contact.idx, "g": g})
    return fuse_groups(spec, groups, with_hess=False)


def all_groups(spec, params, pos, ref_angle, contact, with_hess=True, spd=True):
    """Every element soup fused into ONE padded block group:
        idx: (E, 4) (3-vertex elements padded with the ghost vertex NV)
        g:   (E, 4, 3)
        H:   (E, 4, 4, 3, 3) when with_hess
    Barrier and friction share the contact stencil and are summed. With
    the Hessian, CUDA tensors take the two kernels of ops/element_kernels
    (hyper-dual Hessians) and CPU tensors the torch.func code below."""
    if not with_hess:
        return force_groups_from_soups(
            spec, params, gather_soups(spec, contact, pos), ref_angle, contact)
    if pos.is_cuda:
        return _kernel_groups(spec, params, pos, ref_angle, contact, spd)
    return plain_groups(spec, params, pos, ref_angle, contact, spd)


def plain_groups(spec, params, pos, ref_angle, contact, spd=True):
    """all_groups(with_hess=True) by torch.func on any device: the plain
    version of the element kernels, which CPU tensors take."""
    groups = [membrane_eval(spec, params, pos, True, spd)[1],
              bending_eval(spec, params, pos, ref_angle, True, spd)[1]]
    if spec.neo.tets.shape[0]:
        groups.append(neo_eval(spec, params, pos, True, spd)[1])
    if spec.tact.tets.shape[0]:
        groups.append(tact_eval(spec, params, pos, True, spd)[1])
    _, gc = barrier_eval(spec, contact, pos, True, spd)
    _, gf = friction_eval(spec, contact, pos, True, spd)
    groups.append({"idx": gc["idx"], "g": gc["g"] + gf["g"],
                   "H": gc["H"] + gf["H"]})
    return fuse_groups(spec, groups, True)


def _kernel_groups(spec, params, pos, ref_angle, contact, spd):
    """all_groups(with_hess=True) on the card: element_eval, each family's
    eigh (or shift) projection as the torch.func route makes it, and
    element_fuse into fuse_groups' layout."""
    blocks = _ek.element_eval(spec, params, pos, ref_angle, contact, spd)
    if spd:
        for name in _ek.PSD_BLOCKS:
            if blocks[name].shape[0]:
                blocks[name] = project_psd_method(
                    blocks[name], spec.spd_method).contiguous()
    return _ek.element_fuse(spec, contact, blocks)


def fuse_groups(spec, groups, with_hess=True):
    ghost = spec.NV
    idxs, gs, Hs = [], [], []
    for g in groups:
        idx = g["idx"]
        E, k = idx.shape
        if k < 4:
            pad = 4 - k
            idx = torch.cat([idx, idx.new_full((E, pad), ghost)], dim=1)
            if with_hess:
                Hs.append(tF.pad(g["H"], (0, 0, 0, 0, 0, pad, 0, pad)))
        elif with_hess:
            Hs.append(g["H"])
        idxs.append(idx)
        gs.append(_pad_rows(g["g"], 4))
    fused = {"idx": torch.cat(idxs), "g": torch.cat(gs)}
    if with_hess:
        fused["H"] = torch.cat(Hs)
    return fused


# --------------------------------------------------------------------------
# Assembly (operates on the fused group)
# --------------------------------------------------------------------------


def _dest_groups(fams, key_of, src_of):
    """Families grouped by destination slice, in first-seen order (the
    JAX assembly sums the sources of one destination before adding)."""
    dests = {}
    for fam in fams:
        dests.setdefault(key_of(fam), []).append(src_of(fam))
    return dests.items()


def assemble_residual(spec, fused, pos, prev_pos, vel):
    """Global gradient of the incremental potential, frozen DOFs zeroed
    (reference compute_residual_and_Hessian:976-989 + apply_frozen). With a
    DiaPlan, the cloth families add as static slices, the tet rows by the
    plan's row table, and only the contact part scatters; without one,
    every element row scatters into an (NV+1, 3) buffer whose last row is
    the ghost vertex of the padded stencils."""
    X = pos - prev_pos - vel * spec.dt
    F = spec.mass[:, None] * X / spec.dt**2
    F = F - spec.mass[:, None] * spec.gravity
    F = F - spec.ext_force
    if spec.dia is None:
        Fp = torch.cat([F, F.new_zeros((1, 3))])
        Fp.index_add_(0, fused["idx"].reshape(-1), fused["g"].reshape(-1, 3))
        return torch.where(spec.frozen, torch.zeros_like(F), Fp[: spec.NV])
    plan = spec.dia
    ns = static_block_count(spec)
    g = fused["g"]
    Fp = F.new_zeros((spec.NV + 1, 3))
    for (N, M, v_off, fb, hb, _fams, res_fams), pm in zip(
            plan.cloths, spec.dev.par_masks):
        gf = g[fb : fb + 2 * N * M].reshape(N, M, 2, 4, 3).permute(
            2, 3, 4, 0, 1).contiguous()  # (2, 4, 3, N, M)
        gh = g[hb : hb + 6 * N * M].reshape(N, M, 6, 4, 3).permute(
            2, 3, 4, 0, 1).contiguous()
        acc = F.new_zeros((3, N + 1, M + 1))
        for (I0, I1, J0, J1), srcs in _dest_groups(
                res_fams,
                lambda f: (f[3] + f[7], f[4] + f[7], f[5] + f[8], f[6] + f[8]),
                lambda f: (f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[9])):
            tot = None
            for (kind, cc, a, i0, i1, j0, j1, par) in srcs:
                gg = gf if kind == 0 else gh
                term = gg[cc, a, :, i0:i1, j0:j1] * pm[par, i0:i1, j0:j1]
                tot = term if tot is None else tot + term
            acc[:, I0:I1, J0:J1] += tot
        Fp[v_off : v_off + (N + 1) * (M + 1)] += acc.reshape(3, -1).T
    gflat = torch.cat([g[:ns].reshape(ns * 4, 3), g.new_zeros((1, 3))])
    if plan.rows.shape[0]:
        Fp.index_add_(0, plan.rows, gflat[plan.row_tab].sum(dim=1))
    if plan.extra_ea.shape[0]:
        Fp.index_add_(0, plan.extra_rows, gflat[plan.extra_ea])
    Fp.index_add_(0, fused["idx"][ns:].reshape(-1), g[ns:].reshape(-1, 3))
    F = F + Fp[: spec.NV]
    return torch.where(spec.frozen, torch.zeros_like(F), F)


def dense_hessian(spec, fused):
    """The full (3NV, 3NV) Hessian of the dense solve. Frozen rows and
    columns of the element blocks are dropped; the inertia diagonal m/dt^2
    is kept for every DOF (the reference adds the mass diagonal outside
    add_H). The blocks accumulate into the flattened (3(NV+1))^2 matrix,
    whose last three rows and columns (the ghost vertex) are cut off."""
    n = (spec.NV + 1) * 3
    md = spec.mass
    unf = spec.dev.unf_p.reshape(-1)
    idx, Hb = fused["idx"], fused["H"]
    ar3 = torch.arange(3, device=idx.device)
    dof = idx[..., None] * 3 + ar3  # (E, 4, 3)
    rows = dof[:, :, None, :, None].expand(Hb.shape)
    cols = dof[:, None, :, None, :].expand(Hb.shape)
    vals = Hb * unf[rows] * unf[cols]
    H = md.new_zeros((n * n,))
    H.index_add_(0, (rows * n + cols).reshape(-1), vals.reshape(-1))
    nv3 = spec.NV * 3
    H = H.reshape(n, n)[:nv3, :nv3].contiguous()
    H.diagonal().add_(torch.repeat_interleave(md / spec.dt**2, 3))
    return H


def hvp(spec, fused, x):
    """Matrix-free H @ x on an (NV, 3) vector with the frozen masking of
    dense_hessian: every element block gathers, multiplies and scatters
    (the operator of a CG scene without hvp slots)."""
    unf = spec.dev.unf_p.to(x.dtype)
    y = (spec.mass / spec.dt**2).to(x.dtype)[:, None] * x
    xp = torch.cat([x, x.new_zeros((1, 3))]) * unf
    idx = fused["idx"]
    contrib = torch.einsum("eabij,ebj->eai", fused["H"], xp[idx]) * unf[idx]
    yp = torch.zeros_like(xp)
    yp.index_add_(0, idx.reshape(-1), contrib.reshape(-1, 3))
    return y + yp[: spec.NV]


def diag_blocks(spec, fused):
    """(NV, 3, 3) block diagonal of the assembled Hessian (block-Jacobi),
    in the element blocks' dtype, not the spec mass's: the adjoint may
    solve in another precision than the spec's."""
    Hb = fused["H"]
    unf = spec.dev.unf_p.to(Hb.dtype)
    idx = fused["idx"]
    D = Hb.new_zeros((spec.NV + 1, 3, 3))
    for a in range(4):
        m = unf[idx[:, a]]
        D.index_add_(0, idx[:, a], Hb[:, a, a] * m[:, :, None] * m[:, None, :])
    eye = torch.eye(3, dtype=Hb.dtype, device=Hb.device)
    md = spec.mass.to(Hb.dtype) / spec.dt**2
    return D[: spec.NV] + md[:, None, None] * eye


def gather_neighbor_blocks(spec, fused, x_dtype):
    """(R, D, 3, 3) leftover static blocks in pull layout, frozen-masked.
    Done once per operator build."""
    sl = spec.hvp_slots
    nbr = fused["H"][sl.slot_e, sl.slot_ab // 4, sl.slot_ab % 4]
    unf_p = spec.dev.unf_p.to(x_dtype)
    colm = unf_p[sl.slot_col]                 # (R, D, 3)
    rowm = unf_p[sl.row_ids][:, None, :]      # (R, 1, 3)
    return nbr * rowm[..., None] * colm[:, :, None, :]


def assemble_dia(spec, fused, dtype):
    """(n_off, 3, 3, NVp) diagonal store from the fused static blocks, once
    per operator build: cloth families as static slice-adds, tet blocks as a
    compact row gather + one-hot lane placement."""
    plan = spec.dia
    n_off = len(plan.offsets)
    ns = static_block_count(spec)
    H = fused["H"]
    dia = H.new_zeros((n_off, 3, 3, plan.NVp), dtype=dtype)
    for (N, M, v_off, fb, hb, fams, _res), pm in zip(plan.cloths,
                                                     spec.dev.par_masks):
        Hf = H[fb : fb + 2 * N * M].reshape(N, M, 2, 4, 4, 3, 3).permute(
            2, 3, 4, 5, 6, 0, 1).contiguous()  # (2, 4, 4, 3, 3, N, M)
        Hh = H[hb : hb + 6 * N * M].reshape(N, M, 6, 4, 4, 3, 3).permute(
            2, 3, 4, 5, 6, 0, 1).contiguous()
        acc = H.new_zeros((n_off, 3, 3, N + 1, M + 1), dtype=dtype)
        for (o, I0, I1, J0, J1), srcs in _dest_groups(
                fams,
                lambda f: (f[4], f[5] + f[9], f[6] + f[9], f[7] + f[10],
                           f[8] + f[10]),
                lambda f: (f[0], f[1], f[2], f[3], f[5], f[6], f[7], f[8],
                           f[11])):
            tot = None
            for (kind, cc, a, b, i0, i1, j0, j1, par) in srcs:
                Hg = Hf if kind == 0 else Hh
                term = Hg[cc, a, b, :, :, i0:i1, j0:j1] * pm[par, i0:i1, j0:j1]
                tot = term if tot is None else tot + term
            acc[o, :, :, I0:I1, J0:J1] += tot
        dia[:, :, :, v_off : v_off + (N + 1) * (M + 1)] += acc.reshape(
            n_off, 3, 3, -1)
    if plan.rows.shape[0]:
        Hea = torch.cat([H[:ns].reshape(ns * 4, 4, 3, 3),
                         H.new_zeros((1, 4, 3, 3))])
        vals = Hea[plan.row_tab].reshape(-1, plan.Dr * 4, 9).to(dtype)
        part = torch.einsum("rkc,rko->ocr", vals, spec.dev.onehot)[:n_off]
        dia.index_add_(3, plan.rows, part.reshape(n_off, 3, 3, -1))
    return dia


def diag_blocks_dia(spec, fused, dia, nbr_left, return_contact=False):
    """(NV, 3, 3) block diagonal: the DIA store's offset-0 lane + leftover
    pull diagonal + dynamic contact diagonal + inertia, frozen-masked. With
    return_contact, also the contact-only diagonal."""
    NV = spec.NV
    md = spec.mass
    unf = spec.dev.unf
    D = dia[spec.dev.off0, :, :, :NV].permute(2, 0, 1)
    D = D * unf[:, :, None] * unf[:, None, :]
    sl = spec.hvp_slots
    if sl is not None and sl.D > 0 and nbr_left is not None:
        diag_m = (sl.slot_col == sl.row_ids[:, None]).to(md.dtype)
        D = D.index_add(0, sl.row_ids,
                        torch.einsum("rd,rdij->rij", diag_m, nbr_left))
    ns = static_block_count(spec)
    idx = fused["idx"][ns:]
    unf_p = spec.dev.unf_p
    Dp = md.new_zeros((NV + 1, 3, 3))
    for a in range(4):
        m = unf_p[idx[:, a]]
        Dp.index_add_(0, idx[:, a],
                      fused["H"][ns:, a, a] * m[:, :, None] * m[:, None, :])
    eye = torch.eye(3, dtype=md.dtype, device=md.device)
    D = D + Dp[:NV] + (md / spec.dt**2)[:, None, None] * eye
    if return_contact:
        return D, Dp[:NV]
    return D


def use_spmv_kernel(spec, x) -> bool:
    """Route of the DIA SpMV and preconditioner for tensor x (the JAX
    use_pallas_spmv): 'auto' takes the CUDA kernels for CUDA tensors and
    the plain versions on the CPU; 'kernel' requires CUDA; 'plain' never
    takes the kernels."""
    if spec.spmv == "plain":
        return False
    if spec.spmv == "kernel":
        if not x.is_cuda:
            raise ValueError("spmv='kernel' needs CUDA tensors; the scene is "
                             f"on {x.device}")
        return True
    if spec.spmv == "auto":
        return x.is_cuda
    raise ValueError(f"unknown spmv route {spec.spmv!r}")


def to_t2(spec, v):
    """(NV, 3) -> (3, NVp) transposed vector, zero padding."""
    out = v.new_zeros((3, spec.dia.NVp))
    out[:, : spec.NV] = v.T
    return out


def from_t2(spec, v2):
    """(3, NVp) -> (NV, 3)."""
    return v2[:, : spec.NV].T


def t2_consts(spec, dtype):
    """unf2 (3, NVp) unfrozen mask and m2 (NVp,) inertia diagonal, zero in
    the padding, for the transposed-layout solve."""
    NV, NVp = spec.NV, spec.dia.NVp
    unf2 = spec.mass.new_zeros((3, NVp), dtype=dtype)
    unf2[:, :NV] = (~spec.frozen).to(dtype).T
    m2 = spec.mass.new_zeros((NVp,), dtype=dtype)
    m2[:NV] = spec.mass.to(dtype) / spec.dt**2
    return unf2, m2


def blocks_to_t33(spec, B, dtype):
    """(NV, 3, 3) per-vertex blocks -> (3, 3, NVp), zero padding."""
    out = B.new_zeros((3, 3, spec.dia.NVp), dtype=dtype)
    out[:, :, : spec.NV] = B.permute(1, 2, 0)
    return out


def dia_apply(spec, dia, xm2):
    """The DIA SpMV of the (3, NVp) store on a (3, NVp) vector: the CUDA
    kernel (on a contiguous copy where xm2 has other strides, as an einsum
    may leave it) or its plain version, see use_spmv_kernel."""
    if use_spmv_kernel(spec, xm2):
        return _spmv.dia_spmv(dia, xm2.contiguous(), spec.dia.offsets,
                              spec.dev.offsets_t)
    return _spmv.dia_spmv_plain(dia, xm2, spec.dia.offsets)


def hvp_dia_static_T(spec, dia, nbr_left, x2, unf2, m2):
    """Static part of H @ x in the transposed (3, NVp) layout: the DIA
    SpMV (dia_apply), the leftover pull product and the inertia diagonal,
    frozen-masked. x2: (3, NVp) zero-padded; unf2: unfrozen mask; m2:
    mass/dt^2."""
    xm2 = x2 * unf2  # column mask
    y2 = dia_apply(spec, dia, xm2) * unf2 + m2 * x2  # row mask + inertia
    sl = spec.hvp_slots
    if sl is not None and sl.D > 0:
        xg = xm2[:, sl.slot_col]  # (3, R, D)
        yr = torch.einsum("rdij,jrd->ir", nbr_left, xg)
        y2 = y2.index_add(1, sl.row_ids, yr)
    return y2


def _pull_apply(spec, nbr, xm):
    """Leftover pull product: per-row (R, D) slot contraction of the
    (NV+1, 3) vector xm (ghost row last)."""
    return torch.einsum("rdij,rdj->ri", nbr, xm[spec.hvp_slots.slot_col])


def hvp_pull(spec, nbr, fused, x):
    """H @ x on a scene without a DIA plan (the pull path): the static part
    as a gather + einsum over the precomputed neighbour blocks, only the
    dynamic contact part as a scatter."""
    sl = spec.hvp_slots
    unf = spec.dev.unf_p.to(x.dtype)
    xp = torch.cat([x, x.new_zeros((1, 3))])
    y = torch.zeros_like(x).index_add(0, sl.row_ids,
                                      _pull_apply(spec, nbr, xp))
    y = y + (spec.mass / spec.dt**2).to(x.dtype)[:, None] * x
    ns = static_block_count(spec)
    idx = fused["idx"][ns:]
    xpm = xp * unf
    contrib = torch.einsum("eabij,ebj->eai", fused["H"][ns:],
                           xpm[idx]) * unf[idx]
    yp = torch.zeros_like(xp)
    yp.index_add_(0, idx.reshape(-1), contrib.reshape(-1, 3))
    return y + yp[: spec.NV]


def _padded_static_idx(spec):
    """(ns, 4) numpy: the fused-order static element vertex ids, 3-vertex
    elements padded with the ghost vertex NV (as fuse_groups pads them).
    Takes the builder's (numpy) spec."""
    f2v = np.asarray(spec.cloth.f2v)
    parts = [np.concatenate([f2v, np.full((f2v.shape[0], 1), spec.NV,
                                          f2v.dtype)], axis=1),
             np.asarray(spec.cloth.hinge_verts)]
    for soup in (spec.neo, spec.tact):
        t = np.asarray(soup.tets)
        if t.shape[0]:
            parts.append(t)
    return np.concatenate(parts, axis=0)


def hvp_dia_static(spec, dia, nbr_left, x):
    """Static part of H @ x on an (NV, 3) vector (the adjoint GMRES
    operator): the DIA SpMV (dia_apply) on the zero-padded, column-masked
    (3, NVp) image of x, the leftover pull product and the inertia
    diagonal, frozen-masked."""
    unf = spec.dev.unf.to(x.dtype)
    # to_t2 writes a fresh buffer: the kernel takes contiguous input
    y = from_t2(spec, dia_apply(spec, dia, to_t2(spec, x * unf))) * unf
    y = y + (spec.mass / spec.dt**2).to(x.dtype)[:, None] * x
    sl = spec.hvp_slots
    if sl is not None and sl.D > 0:
        xm = torch.cat([x * unf, x.new_zeros((1, 3))])
        y = y.index_add(0, sl.row_ids, _pull_apply(spec, nbr_left, xm))
    return y


def hvp_dia_contact(spec, fused, x):
    """Dynamic contact part of H @ x on an (NV, 3) vector, frozen-masked.
    With the contact split in `fused` (idx_con/H_con, optional Dcon and the
    'mm' pairs' mm_S/mm_H): the frozen-source diagonal as one einsum, the
    'mm' pairs as one-hot selection matmuls over the source body's vertex
    slice, and only the remaining slots as gather + scatter-add."""
    NV = spec.NV
    unf = spec.dev.unf_p.to(x.dtype)
    xp = torch.cat([x, x.new_zeros((1, 3))])
    xm = xp * unf
    yp = torch.zeros_like(xp)
    y_diag = torch.zeros_like(x)
    if "idx_con" in fused:
        idx, Hd = fused["idx_con"], fused["H_con"]
        if "Dcon" in fused:
            y_diag = torch.einsum("nij,nj->ni", fused["Dcon"], x)
        if "mm_S" in fused:
            _d, mm_ranges, _g = spec.dev.contact_split
            for (_cs, cnt, v_lo, f_vlo, f_vn), S, Hm in zip(
                    mm_ranges, fused["mm_S"], fused["mm_H"]):
                xf = torch.einsum("caf,fj->caj", S, xm[f_vlo : f_vlo + f_vn])
                xq = xm[v_lo : v_lo + cnt]
                xg = torch.cat([xf, xq[:, None, :]], dim=1)  # (cnt, 4, 3)
                contrib = torch.einsum("eabij,ebj->eai", Hm, xg)
                yp[v_lo : v_lo + cnt] += contrib[:, 3] * unf[v_lo : v_lo + cnt]
                yf = torch.einsum("caf,cai->fi", S, contrib[:, :3])
                yp[f_vlo : f_vlo + f_vn] += yf * unf[f_vlo : f_vlo + f_vn]
    else:
        ns = static_block_count(spec)
        idx, Hd = fused["idx"][ns:], fused["H"][ns:]
    if idx.shape[0] > 0:
        contrib = torch.einsum("eabij,ebj->eai", Hd, xm[idx]) * unf[idx]
        yp.index_add_(0, idx.reshape(-1), contrib.reshape(-1, 3))
    return yp[:NV] + y_diag


def hvp_dia(spec, dia, nbr_left, fused, x):
    """H @ x with the hybrid layout on an (NV, 3) vector: DIA SpMV for the
    regular offsets, pull gather for the leftover, the contact part."""
    return (hvp_dia_static(spec, dia, nbr_left, x)
            + hvp_dia_contact(spec, fused, x))


def frozen_column_product(spec, fused, z):
    """tmp_z_frozen[j] = - sum_{i unfrozen} H_ij z_i for frozen DOFs j
    (reference add_H counting path, BaseScene.py:403-405). z: (NV, 3)."""
    unf = spec.dev.unf_p.to(z.dtype)
    fro = 1.0 - unf
    fro[-1] = 0.0  # the ghost row
    zp = torch.cat([z, z.new_zeros((1, 3))])
    idx = fused["idx"]
    contrib = torch.einsum("eabij,eai->ebj", fused["H"], zp[idx] * unf[idx])
    tp = torch.zeros_like(zp)
    tp.index_add_(0, idx.reshape(-1), (-contrib * fro[idx]).reshape(-1, 3))
    return tp[: spec.NV]


def hvp_dia_contact_T(spec, fused, x2, unf2, DconT=None):
    """Dynamic contact part of H @ x in the transposed layout: the
    frozen-source diagonal (DconT, (3, 3, NVp)), the 'mm' pairs as one-hot
    selection matmuls over the source body's vertex slice, and the remaining
    slots as gather + scatter-add."""
    xm2 = x2 * unf2
    yp2 = torch.zeros_like(x2)
    y_diag2 = torch.zeros_like(x2)
    if "idx_con" in fused:
        idx, Hd = fused["idx_con"], fused["H_con"]
        if DconT is not None:
            y_diag2 = torch.einsum("ijn,jn->in", DconT, x2)
        if "mm_S" in fused:
            _d, mm_ranges, _g = spec.dev.contact_split
            for (_cs, cnt, v_lo, f_vlo, f_vn), S, Hm in zip(
                    mm_ranges, fused["mm_S"], fused["mm_H"]):
                xf = torch.einsum("caf,jf->caj", S,
                                  xm2[:, f_vlo : f_vlo + f_vn])
                xq = xm2[:, v_lo : v_lo + cnt].T
                xg = torch.cat([xf, xq[:, None, :]], dim=1)  # (cnt, 4, 3)
                contrib = torch.einsum("eabij,ebj->eai", Hm, xg)
                yp2[:, v_lo : v_lo + cnt] += (contrib[:, 3].T
                                              * unf2[:, v_lo : v_lo + cnt])
                yf = torch.einsum("caf,cai->if", S, contrib[:, :3])
                yp2[:, f_vlo : f_vlo + f_vn] += yf * unf2[:, f_vlo : f_vlo + f_vn]
    else:
        ns = static_block_count(spec)
        idx, Hd = fused["idx"][ns:], fused["H"][ns:]
    if idx.shape[0] > 0:
        xg = xm2[:, idx]  # (3, C, 4)
        contrib = torch.einsum("eabij,jeb->iea", Hd, xg) * unf2[:, idx]
        yp2.index_add_(1, idx.reshape(-1), contrib.reshape(3, -1))
    return yp2 + y_diag2


def build_contact_split(spec, idx_c, H_c, dtype):
    """Per-operator-build arrays of the split contact matvec: the exact
    frozen-source diagonal Dcon (NV, 3, 3), the one-hot selection matrices
    and Hessian slices of the 'mm' pairs, and the compacted (idx, H) of the
    remaining general slots. idx_c/H_c are the contact rows of the fused
    group; inactive slots carry exactly-zero blocks."""
    split = spec.dev.contact_split
    if split is None:
        return None
    diag_ranges, mm_ranges, gen_ranges = split
    out = {}
    if diag_ranges:
        unf = spec.dev.unf.to(dtype)
        Dcon = H_c.new_zeros((spec.NV, 3, 3), dtype=dtype)
        for (cs, cnt, v_lo) in diag_ranges:
            Dcon[v_lo : v_lo + cnt] += H_c[cs : cs + cnt, 3, 3]
        out["Dcon"] = Dcon * unf[:, :, None] * unf[:, None, :]
    if mm_ranges:
        Ss, Hs = [], []
        for (cs, cnt, _v_lo, f_vlo, f_vn) in mm_ranges:
            loc = idx_c[cs : cs + cnt, :3] - f_vlo  # (cnt, 3) local ids
            ar = torch.arange(f_vn, dtype=loc.dtype, device=loc.device)
            Ss.append((loc[..., None] == ar).to(dtype))  # (cnt, 3, f_vn)
            Hs.append(H_c[cs : cs + cnt])
        out["mm_S"] = tuple(Ss)
        out["mm_H"] = tuple(Hs)
    if gen_ranges:
        out["idx_con"] = torch.cat([idx_c[cs : cs + cnt]
                                    for (cs, cnt) in gen_ranges])
        out["H_con"] = torch.cat([H_c[cs : cs + cnt]
                                  for (cs, cnt) in gen_ranges])
    else:
        out["idx_con"] = idx_c[:0]
        out["H_con"] = H_c[:0]
    return out
