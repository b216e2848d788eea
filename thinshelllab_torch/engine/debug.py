"""Debug / diagnostic utilities (counterpart of
`thinshelllab_tpu/engine/debug.py`).

check_differential: finite-difference consistency check of the assembled
energy/residual/Hessian at a state (the reference's embedded de-facto unit
test, BaseScene.check_differential:880-974), exposed as a public API and
usable on any scene.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.spec import Params, SceneSpec
from . import elements
from .stepper import build_contacts


def check_differential(spec: SceneSpec, params: Params, state, eps=1e-6,
                       seed=0, verbose=True):
    """Perturb positions by a random unfrozen direction of norm `eps` and
    compare E1-E0 vs F.dx and H dx vs F1-F0. spec, params and state moved
    to one device (TaskScene.to); runs there. Returns a dict of errors."""
    pos = state.pos
    prev = pos
    vel = state.vel
    ref = state.ref_angle
    contact, _, _ = build_contacts(spec, params, pos, prev, state.proj_flag,
                                   state.proj_dir)

    def energy(p):
        return elements.total_energy(spec, params, p, prev, vel, ref, contact)

    def residual(p):
        groups = elements.all_groups(spec, params, p, ref, contact,
                                     with_hess=False, spd=False)
        return elements.assemble_residual(spec, groups, p, prev, vel)

    # the JAX package's seeded direction, drawn with numpy on the host
    rng = np.random.default_rng(seed)
    dx = rng.standard_normal(tuple(pos.shape))
    dx[spec.frozen.cpu().numpy()] = 0.0
    dx = torch.as_tensor(dx * (eps / np.linalg.norm(dx)), dtype=pos.dtype,
                         device=pos.device)

    # central differences cancel the second-order term (the reference uses
    # forward differences, BaseScene:955, which is noisier on stiff H)
    E0 = float(energy(pos - dx))
    E1 = float(energy(pos + dx))
    F0 = residual(pos - dx)
    F1 = residual(pos + dx)
    Fc = residual(pos)
    dE_pred = 2.0 * float(torch.sum(Fc * dx))

    groups = elements.all_groups(spec, params, pos, ref, contact,
                                 with_hess=True, spd=False)
    Hdx = 2.0 * elements.hvp(spec, groups, dx)
    dF_true = F1 - F0
    grad_err = abs((E1 - E0) - dE_pred) / max(abs(E1 - E0), 1e-30)
    hess_err = float(torch.linalg.vector_norm(Hdx - dF_true)
                     / torch.clamp(torch.linalg.vector_norm(dF_true),
                                   min=1e-30))
    out = {
        "dE_fd": E1 - E0,
        "dE_analytic": dE_pred,
        "grad_rel_err": grad_err,
        "hess_rel_err": hess_err,
    }
    if verbose:
        print(f"Gradient Check: dE_fd={E1 - E0:.3e} F.dx={dE_pred:.3e} "
              f"rel={grad_err:.2e}")
        print(f"Hessian Check: |Hdx - dF|/|dF| = {hess_err:.2e}")
    return out
