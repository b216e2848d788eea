"""The self-contact test scene: one 12x12 cloth folded into a hairpin whose
top layer hovers 0.3 mm (below eps_contact, 0.4 mm) over its frozen bottom
layer, with one self-contact pair (the JAX package's
tests/test_collision.py::test_self_contact_hairpin_end_to_end; reference
engine/geometry_self.py:166-298, dormant in the reference's task scenes).

The top layer is shifted by 0.37 and 0.43 cells along the two tangential
axes, so that its vertices project strictly inside bottom-layer faces
(grid-aligned layers put every projection exactly on a shared edge).
"""
from __future__ import annotations

import numpy as np
import torch

N = M = 12
SIZE = 0.1
GAP = 3e-4


def initial_positions():
    """(NV, 3) float64: the bottom half of the grid flat at z=0, the top
    half folded back over it at z=GAP."""
    dx = SIZE / N
    pos = np.zeros(((N + 1) * (M + 1), 3))
    for i in range(N + 1):
        for j in range(M + 1):
            k = i * (M + 1) + j
            if i <= N // 2:
                pos[k] = (i * dx, j * dx, 0.0)
            else:
                pos[k] = ((N - i) * dx + 0.37 * dx, j * dx + 0.43 * dx, GAP)
    return pos


def make(dtype=torch.float64, builder_cls=None):
    """(spec, state0, params) of the hairpin, built by `builder_cls` (the
    port's SceneBuilder by default; any builder with its interface) in
    `dtype`: the dense solver, max_newton_iter 4, the bottom layer frozen."""
    if builder_cls is None:
        from ..core.builder import SceneBuilder as builder_cls
    b = builder_cls(dt=5e-3, k_contact=10000.0, eps_contact=4e-4,
                    eps_v=1e-2, damping=1.0, max_newton_iter=4,
                    gravity=(0.0, 0.0, -9.8), plastic=False,
                    solver="dense", dtype=dtype)
    cloth = b.add_cloth(N, M, SIZE, rho=40.0, init_pos=initial_positions())
    b.add_self_contact_pair(cloth, b.new_mu_slot(0.5))

    def freeze_bottom(bb, frozen):
        vs, _ = bb.vrange(cloth)
        frozen[vs : vs + (N // 2 + 1) * (M + 1)] = True

    b.freeze(freeze_bottom)
    return b.build()


def probe(spec, s0, params):
    """The self-contact path on a moved hairpin (spec, s0, params on one
    device): the projection from unlatched flags (flag, dir, tri, w), the
    contact set's active slots, the gradient of the incremental potential
    at the initial state (prev_pos = pos, zero velocity) through that set,
    and the positions after one implicit step with no action. A dict of
    tensors on the scene's device."""
    from ..engine import elements, stepper
    from ..ops import collision

    p = s0.pos
    z = torch.zeros_like(s0.proj_flag)
    vn = collision.vertex_normals(p, spec.faces, spec.NV)
    flag, pdir, tri, w = collision.projection_query(spec, p, vn, z, z)
    contact, _, _ = stepper.build_contacts(spec, params, p, p, z, z)
    x = p.clone().requires_grad_(True)
    with torch.enable_grad():
        e = elements.total_energy(spec, params, x, p, torch.zeros_like(p),
                                  s0.ref_angle, contact)
        (g,) = torch.autograd.grad(e, x)
    none = (p.new_zeros((0, 3)), p.new_zeros((0, 3)), p.new_zeros((0,)))
    st1, _ = stepper.time_step(spec, params, s0, none)
    return {"flag": flag, "dir": pdir, "tri": tri, "w": w,
            "active": contact.active, "grad": g, "pos1": st1.pos}
