"""Trajectory adjoint: the implicit-function-theorem backward pass
(counterpart of `thinshelllab_tpu/engine/adjoint.py`; reference
engine/analytic_grad_single.py:217-257 and analytic_grad_system.py:115-160).

Per step t, from T-1 down to 1:
  1. clamp the accumulated dL/dx_t and dL/dref_t to +-1000
  2. the step's contact set: the taped one (simulate(save_contacts=True))
     or a rebuild at x_{t-1} with the latched projection state carried
     backwards
  3. the plastic a2ax chain: dL/dref_t flows to dL/dref_{t-1} and, scaled
     by the yield gate (1 inside yield, 0.1 otherwise), into dL/dx_t
  4. solve H(x_t) z = dL/dx_t with the true (unprojected) Hessian by
     grid-preconditioned GMRES (MINRES on a scene without a cloth grid
     plan, the LU solve on a dense scene)
  5. frozen-column products -> the effector's 6-DoF gradients
  6. x_hat_grad = M z / dt^2: dL/dx_{t-1} += (1 + damping) x_hat_grad,
     dL/dx_{t-2} -= damping x_hat_grad (unfrozen DOFs)
  7. the friction pressure and rest-offset chains into dL/dx_{t-1}
  8. the bending ref chain x2a: dL/dref_{t-1} += -z . dF/dref
  9. with_param_grad: dL/dp -= z . dF/dp, by autograd of the residual
     with respect to Params

The JAX sweep is a lax.scan; here it is a Python loop carrying the same
tuple.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..core.spec import ContactSet, Params, SceneSpec
from ..ops import collision, energies
from ..utils.quaternion import quat_to_rotmat
from . import elements, solver


class AdjointResult(NamedTuple):
    gripper_grad: torch.Tensor  # (T, n_part, 6)
    param_grad: Params
    pos_grad0: torch.Tensor     # residual dL/dx_0 (diagnostic)


def _two_sum(a, b):
    """Error-free transformation: s + e == a + b exactly (Knuth TwoSum,
    branch-free). PyTorch runs each operation as written, so the
    compensation term is not reassociated away."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _comp_add(hi, lo, x):
    """Compensated accumulate: (hi, lo) + x with one TwoSum; the rounding
    of the running sum lands in lo."""
    s, e = _two_sum(hi, x)
    return s, lo + e


def _cast_float(obj, dt):
    """Copy of a ContactSet / Params with every float leaf in dt."""
    return obj.replace(**{
        f.name: getattr(obj, f.name).to(dt)
        for f in dataclasses.fields(obj)
        if getattr(obj, f.name).is_floating_point()})


def _cast_spec(spec, dt):
    """Copy of a moved spec with every float tensor, its DeviceConsts'
    too, in dt: the adjoint's Hessians and solve in a solve dtype other
    than the spec's read it, so that each sees one float dtype."""
    def cast(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.to(dt)
        if isinstance(v, tuple) and any(isinstance(x, torch.Tensor)
                                        for x in v):
            return tuple(cast(x) for x in v)
        return v

    consts = spec.dev
    dev = dataclasses.replace(consts, **{
        f.name: cast(getattr(consts, f.name))
        for f in dataclasses.fields(consts)})
    moved = super(SceneSpec, spec).to(spec.mass.device, dt)
    return moved.replace(dtype=dt, dev=dev)


def _rebuild_contact(spec, params, pos_prev, proj_flag, proj_dir):
    vn = collision.vertex_normals(pos_prev, spec.faces, spec.NV)
    proj_flag, proj_dir, tri, w = collision.projection_query(
        spec, pos_prev, vn, proj_flag, proj_dir)
    contact = collision.contact_analysis(
        spec, params.mu_pairs, pos_prev, pos_prev, proj_flag, proj_dir, tri, w)
    return contact, proj_flag, proj_dir


def _hinge_grads(spec, pos):
    """Per-hinge dtheta/dx over the stencil, masked: (NH, 4, 3), theta."""
    c = spec.cloth
    dt = pos.dtype
    x = torch.where(c.hinge_mask[:, None, None], pos[c.hinge_verts],
                    spec.dev.canon.to(dt))
    # one backward pass of the summed angles gives every hinge's gradient
    theta, dth = elements._energies_and_grads(energies.hinge_angle, x,
                                              c.hinge_sel.to(dt))
    return dth * c.hinge_mask.to(dt)[:, None, None], theta


def _contact_energy_backprop(spec, contact: ContactSet, pos_t, z):
    """Friction pressure chain + rest-offset chain into dL/dx_{t-1}
    (reference BaseScene.contact_energy_backprop:682-730)."""
    idx, w, T, k, mu = contact.idx, contact.w, contact.T, contact.k, contact.mu
    eh = spec.eps_v * spec.dt

    u, r = elements.friction_slip(spec, contact, pos_t[idx])
    f1 = elements.friction_f1(spec, r)
    g1 = torch.einsum("ct,cti->ci", u * (k * f1)[:, None], T)  # force dir

    active = contact.active.to(pos_t.dtype)
    zc = z[idx]  # (C, 4, 3)
    ones = w.new_ones((w.shape[0], 1))

    # pressure chain: w1 = [w0, w1, w2, -1]
    wA = torch.cat([w, -ones], dim=1)
    tiny = torch.finfo(k.dtype).tiny
    pressure = k / torch.where(torch.abs(mu) > tiny, mu,
                               torch.full_like(mu, tiny))
    safe_p = torch.where(torch.abs(pressure) > tiny, pressure,
                         torch.full_like(pressure, tiny))
    s1 = torch.einsum("ca,ci,cai->c", wA, g1, zc) / safe_p
    contrib_p = ((s1 * spec.k_contact)[:, None, None] * wA[:, :, None]
                 * contact.n[:, None, :])

    # rest-offset chain: w1 = [-w0, -w1, -w2, 1]
    wB = torch.cat([-w, ones], dim=1)
    tiny_r = torch.finfo(r.dtype).tiny
    f1p = torch.where(r > eh, -1.0 / torch.clamp(r, min=tiny_r) ** 2,
                      torch.full_like(r, -1.0 / eh**2))
    coef = torch.where(r > 1e-9, f1p / torch.clamp(r, min=1e-9),
                       torch.zeros_like(r))
    eye2 = torch.eye(2, dtype=pos_t.dtype, device=pos_t.device)
    h = (f1[:, None, None] * eye2
         + coef[:, None, None] * torch.einsum("ct,cs->cts", u, u))
    h1 = k[:, None, None] * torch.einsum("cti,cts,csj->cij", T, h, T)
    zv = torch.einsum("ca,cai->ci", wB, zc)  # (C, 3)
    contrib_d = wB[:, :, None] * torch.einsum("ci,cij->cj", zv, h1)[:, None, :]

    total = (contrib_p + contrib_d) * active[:, None, None]
    out = torch.zeros_like(pos_t)
    out.index_add_(0, idx.reshape(-1), total.reshape(-1, 3))
    return out


def static_friction_loss_pos_grad(spec, contact: ContactSet, pos_t,
                                  f_loss_ratio):
    """Slip-penalty loss seed: dL/dx_t += f_loss_ratio * k * (T^T u) at
    every sticking contact whose tangential displacement exceeds
    0.9 dt eps_v (reference BaseScene.static_friction_loss:733-776)."""
    idx, w, T, k = contact.idx, contact.w, contact.T, contact.k
    u, r = elements.friction_slip(spec, contact, pos_t[idx])
    gate = contact.active & (r > spec.dt * spec.eps_v * 0.9)
    u3 = torch.einsum("ct,cti->ci", u, T)  # back to 3D: T^T u
    w1 = torch.cat([-w, w.new_ones((w.shape[0], 1))], dim=1)
    coef = torch.where(gate, k * f_loss_ratio, torch.zeros_like(k))
    contrib = coef[:, None, None] * w1[:, :, None] * u3[:, None, :]
    out = torch.zeros_like(pos_t)
    out.index_add_(0, idx.reshape(-1), contrib.reshape(-1, 3))
    return out


def _gather_gripper_grad(spec, rot_t, pad_local_t, tmp_z_frozen):
    """(n_part, 6) from the frozen-column vector (reference gather_grad)."""
    g = spec.gripper
    if g.mode == "none":
        return tmp_z_frozen.new_zeros((0, 6))
    d_pos = tmp_z_frozen.new_zeros((g.n_part, 3))
    d_ang = tmp_z_frozen.new_zeros((g.n_part, 3))
    R = quat_to_rotmat(rot_t)
    for p in range(g.n_pads):
        part = g.pad_part[p]
        grad = tmp_z_frozen[g.pad_offset[p] + g.bound_idx]
        arm = torch.einsum("ij,vj->vi", R[part], pad_local_t[p, g.bound_idx])
        d_pos[part] += torch.sum(grad, dim=0)
        d_ang[part] += torch.sum(energies._cross(arm, grad), dim=0)
    denom = float((2 if g.mode == "paired" else 1) * g.n_bound)
    d_pos = torch.clamp(d_pos / denom, -10.0, 10.0)
    clip_a = 10.0 if g.mode == "paired" else 100.0
    d_ang = torch.clamp(d_ang / denom, -clip_a, clip_a)
    return torch.cat([d_pos, d_ang], dim=1)


def _param_residual_vjp(spec, contact, pos_t, ref_t, z_masked, params):
    """-z . dF/dparams with F the frozen-masked residual at pos_t, by
    autograd with respect to every float leaf of Params; the friction scale
    k is re-derived as mu * pressure so the friction-coefficient chain is
    captured."""
    tiny = torch.finfo(pos_t.dtype).tiny
    mu = contact.mu
    pressure = contact.k / torch.where(torch.abs(mu) > tiny, mu,
                                       torch.full_like(mu, tiny))
    names = [f.name for f in dataclasses.fields(params)]
    with torch.enable_grad():
        leaves = [getattr(params, n).detach().requires_grad_(True)
                  for n in names]
        p = params.replace(**dict(zip(names, leaves)))
        mu_p = p.mu_pairs[spec.contact.cq_mu_id]
        con = contact.replace(k=mu_p * pressure, mu=mu_p)
        fused = elements.all_groups(spec, p, pos_t, ref_t, con,
                                    with_hess=False, spd=False)
        Fp = pos_t.new_zeros((spec.NV + 1, 3)).index_add(
            0, fused["idx"].reshape(-1), fused["g"].reshape(-1, 3))
        F = torch.where(spec.frozen, torch.zeros_like(pos_t), Fp[: spec.NV])
        grads = torch.autograd.grad(F, leaves, grad_outputs=-z_masked,
                                    allow_unused=True)
    return params.replace(**{
        n: torch.zeros_like(leaf) if gr is None else gr
        for n, leaf, gr in zip(names, leaves, grads)})


def backward(
    spec: SceneSpec,
    params: Params,
    buffers,
    seed_pos_grad,
    seed_ar_grad,
    damping_grad: float = 1.0,
    vertical_only: bool = False,
    with_param_grad: bool = False,
    skip_steps: int = 0,
    friction_loss: bool = False,
    f_loss_ratio: float = 0.001,
    warm_start: bool = False,
    debug_iters: bool = False,
    chain_dtype=None,
    solve_dtype=None,
    matmul_precision="solves",
    compensated: bool = False,
) -> AdjointResult:
    """Run the backward sweep over a simulated trajectory.

    buffers: dict from stepper.simulate (with "contact" when it ran with
    save_contacts=True). seed_pos_grad: (T, NV, 3) dL/dx_t seeds;
    seed_ar_grad: (T, NH) dL/dref_t seeds. Returns gripper_grad
    (T, n_part, 6), the accumulated Params cotangent (zeros unless
    with_param_grad) and pos_grad0, the residual dL/dx_0.

    skip_steps: gripper gradients of steps t <= skip_steps are zeroed (the
      sweep still runs through them).
    friction_loss: add the slip-penalty seed (static_friction_loss_pos_grad)
      with weight f_loss_ratio.
    warm_start: seed each step's GMRES with the previous (t+1) step's
      solution, optimally scaled; GMRES converges to the same point.
    debug_iters: return the per-step GMRES iteration counts (int32, in
      sweep order t = T-1 .. 1) in place of pos_grad0.
    chain_dtype / solve_dtype: the precision of the backward chain
      carries and of the Hessian assembly + adjoint solve (default: the
      spec's dtype for both).
    compensated: carry the dL/dx and dL/dref accumulators as (value, error)
      pairs with error-free TwoSum accumulation; identical in exact
      arithmetic.
    matmul_precision: accepted for the JAX signature and ignored. The JAX
      package uses it to keep the TPU's float32 products out of bf16
      passes; the port computes every float32 product in full float32
      (TF32 is off package-wide)."""
    del matmul_precision
    if spec.dev is None:
        raise TypeError("move the scene to a device first: spec.to(device)")
    d = spec.dtype
    cd = chain_dtype if chain_dtype is not None else d
    sd = solve_dtype if solve_dtype is not None else d
    return _backward_body(
        spec, params, buffers, seed_pos_grad, seed_ar_grad, damping_grad,
        vertical_only, with_param_grad, skip_steps, friction_loss,
        f_loss_ratio, warm_start, debug_iters, cd, sd, compensated)


def backward_chunked(spec: SceneSpec, params: Params, buffers, seed_pos_grad,
                     seed_ar_grad, chunk: int, **kwargs) -> AdjointResult:
    """backward() under the JAX package's chunked signature (`chunk`
    followed by backward()'s keywords). The JAX package runs its sweep in
    host-stitched segments of `chunk` steps, a workaround for its TPU
    worker's long scans; the port's sweep is a host loop already, so this
    is backward() itself, bit-equal to it."""
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    return backward(spec, params, buffers, seed_pos_grad, seed_ar_grad,
                    **kwargs)


def _backward_body(spec, params, buffers, seed_pos_grad, seed_ar_grad,
                   damping_grad, vertical_only, with_param_grad, skip_steps,
                   friction_loss, f_loss_ratio, warm_start, debug_iters,
                   cd, sd, comp):
    T = seed_pos_grad.shape[0]
    NV = spec.NV
    d = spec.dtype
    dev = seed_pos_grad.device
    c = spec.cloth
    kb = params.kb[c.hinge_cloth]
    k_angle = torch.as_tensor(c.k_angle, dtype=cd, device=dev)[c.hinge_cloth]
    d_ref_coef = (-2.0 * kb * c.hinge_coef).to(cd)  # dtheta_ref
    unfrozen = spec.dev.unf.to(cd)
    hmask = spec.dev.hinge_m.to(cd)
    inertia = (spec.mass / spec.dt**2).to(cd)[:, None]
    params_sd = params if sd == d else _cast_float(params, sd)
    spec_sd = spec if sd == d else _cast_spec(spec, sd)

    g1 = torch.zeros((NV, 3), dtype=cd, device=dev)
    g2 = torch.zeros_like(g1)
    ar1 = torch.zeros(seed_ar_grad[0].shape, dtype=cd, device=dev)
    g1e, ar1e = torch.zeros_like(g1), torch.zeros_like(ar1)
    proj_flag, proj_dir = buffers["final_proj_flag"], buffers["final_proj_dir"]
    pgrad = params.replace(**{f.name: torch.zeros_like(getattr(params, f.name))
                              for f in dataclasses.fields(params)})
    z_prev = torch.zeros((NV, 3), dtype=sd, device=dev)
    ts = list(range(T - 1, 0, -1))
    ggs, iters = [], []

    for t in ts:
        pos_t = buffers["pos"][t]
        pos_tm1 = buffers["pos"][t - 1]
        # the ref angle step t's energy used: the post-update ref of step
        # t-1 (reference copy_pos_and_refangle, BaseScene.py:290)
        ref_t = buffers["ref_angle"][t - 1]

        if comp:
            # collapse the (value, error) dL/dx carry into the solve seed
            # with one rounding; the dL/dref carry keeps its split across
            # the clip (void where the clamp pins the value)
            s, e = _two_sum(seed_pos_grad[t].to(cd), g1)
            pg_t = torch.clamp(s + (e + g1e), -1000.0, 1000.0)
            ar_hi, ea = _two_sum(seed_ar_grad[t].to(cd), ar1)
            ar_lo = ea + ar1e
            ar_tot = ar_hi + ar_lo
            clipped = torch.abs(ar_tot) >= 1000.0
            ar_t = torch.clamp(ar_tot, -1000.0, 1000.0)
            ar_hi = torch.where(clipped, ar_t, ar_hi)
            ar_lo = torch.where(clipped, torch.zeros_like(ar_lo), ar_lo)
        else:
            pg_t = torch.clamp(seed_pos_grad[t].to(cd) + g1, -1000.0, 1000.0)
            ar_t = torch.clamp(seed_ar_grad[t].to(cd) + ar1, -1000.0, 1000.0)

        if "contact" in buffers:
            # the taped set step t's solve used (index t-1)
            tape = buffers["contact"]
            contact = tape.replace(**{f.name: getattr(tape, f.name)[t - 1]
                                      for f in dataclasses.fields(tape)})
        else:
            contact, proj_flag, proj_dir = _rebuild_contact(
                spec, params, pos_tm1, proj_flag, proj_dir)
        contact_c = _cast_float(contact, cd) if cd != d else contact

        if friction_loss:  # reference AnalyticGrad(friction_loss=True)
            pg_t = pg_t + static_friction_loss_pos_grad(
                spec, contact_c, pos_t.to(cd), f_loss_ratio)

        # plastic chain a2ax at (pos_t, ref_t), gated by the forward's own
        # yield decisions when the tape has them
        dth, theta = _hinge_grads(spec, pos_t.to(cd))
        if "yield_gate" in buffers:
            yielded = buffers["yield_gate"][t]
        else:
            yielded = torch.abs(theta - ref_t.to(cd)) > k_angle
        factor = torch.where(yielded, hmask.new_tensor(1.0),
                             hmask.new_tensor(0.1)) * hmask
        contrib = (ar_t * factor)[:, None, None] * dth
        pg_t = pg_t.index_add(0, c.hinge_verts.reshape(-1),
                              contrib.reshape(-1, 3))
        if comp:
            ar_next, ar_next_lo = ar_hi * hmask, ar_lo * hmask
        else:
            ar_next = ar_t * hmask  # dL/dref_{t-1} pass-through

        # true Hessian at pos_t, solve H z = pg_t
        groups = elements.all_groups(
            spec_sd, params_sd, pos_t.to(sd), ref_t.to(sd),
            contact if sd == d else _cast_float(contact, sd),
            with_hess=True, spd=False)
        z, it = solver.solve_adjoint(
            spec_sd, groups, pg_t.to(sd), x0=z_prev if warm_start else None,
            return_iters=True)
        z_c = z.to(cd)

        tmp_z_frozen = elements.frozen_column_product(spec_sd, groups, z)
        x_hat_grad = z_c * inertia * unfrozen
        bp = _contact_energy_backprop(spec, contact_c, pos_t.to(cd), z_c)

        # bending ref chain x2a: dL/dref_{t-1} += -d_ref * (z . dtheta/dx)
        z_dth = torch.einsum("hai,hai->h", z_c[c.hinge_verts], dth)
        if comp:
            ar_next, ar_next_lo = _comp_add(ar_next, ar_next_lo,
                                            (-d_ref_coef) * z_dth * hmask)
        else:
            ar_next = ar_next + (-d_ref_coef) * z_dth * hmask

        gg = _gather_gripper_grad(spec, buffers["gripper_rot"][t],
                                  buffers["pad_local"][t], tmp_z_frozen)
        if vertical_only:
            gg = gg * gg.new_tensor([0.0, 0.0, 1.0, 0.0, 0.0, 0.0])

        if with_param_grad:
            z_masked = (z_c * unfrozen).to(d)
            pg_contrib = _param_residual_vjp(spec, contact, pos_t, ref_t,
                                             z_masked, params)
            pgrad = pgrad.replace(**{
                f.name: getattr(pgrad, f.name) + getattr(pg_contrib, f.name)
                for f in dataclasses.fields(pgrad)})

        g2_out = -damping_grad * x_hat_grad
        if comp:
            h, e1 = _two_sum(g2, (1.0 + damping_grad) * x_hat_grad)
            g1, e2 = _two_sum(h, bp)
            g1e = e1 + e2  # g2 is a fresh single product (no carry error)
            ar1e = ar_next_lo
        else:
            g1 = g2 + (1.0 + damping_grad) * x_hat_grad + bp
        g2, ar1, z_prev = g2_out, ar_next, z
        if t <= skip_steps:
            gg = torch.zeros_like(gg)
        ggs.append(gg.to(d))
        iters.append(it)

    gripper_grad = torch.zeros((T, max(spec.gripper.n_part, 1), 6), dtype=d,
                               device=dev)
    if spec.gripper.n_part > 0 and ggs:
        gripper_grad[torch.tensor(ts, device=dev)] = torch.stack(ggs)
    if comp:
        g1 = g1 + g1e  # residual dL/dx_0: collapse the split
    pos_grad0 = (torch.tensor(iters, dtype=torch.int32, device=dev)
                 if debug_iters else g1)
    return AdjointResult(gripper_grad=gripper_grad, param_grad=pgrad,
                         pos_grad0=pos_grad0)
