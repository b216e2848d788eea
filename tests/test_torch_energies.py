"""The port's element energies and SPD projections against the JAX
package's: values, gradients and Hessians at the same random inputs, made
from a numpy seed around the small bench scene's stencils, in f64 (rtol
1e-10: the same arithmetic, AD in another framework)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.engine import elements as jelements
from thinshelllab_tpu.ops import energies as jen
from thinshelllab_tpu.ops import spd as jspd
from thinshelllab_tpu.scenes import bench_scene as jbench
from thinshelllab_torch.engine import elements
from thinshelllab_torch.ops import energies as en
from thinshelllab_torch.ops import spd
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-10
K_CONTACT, EPS_CONTACT = 1e4, 4e-4  # the bench scene's barrier


@pytest.fixture(scope="module")
def inputs():
    """Per-element argument tuples of every energy, as numpy, taken from
    the small bench scene's soups at a perturbed state."""
    sc = jbench.make(cloth_N=8, table_n=4, dtype=jnp.float64, solver="cg")
    spec = sc.spec
    rng = np.random.default_rng(0)
    pos = sc.state0.pos + 2e-4 * rng.normal(size=sc.state0.pos.shape)
    c, n = spec.cloth, 64
    out = {}
    out["membrane"] = (pos[c.f2v[:n]], c.l0[:n], c.rest_area[:n],
                       rng.uniform(50, 150, n), rng.uniform(50, 150, n))
    hv = np.flatnonzero(c.hinge_mask)[:n]
    out["bending"] = (pos[c.hinge_verts[hv]], c.hinge_sel[hv],
                      rng.normal(0, 0.05, hv.size), c.hinge_coef[hv],
                      rng.uniform(1e-5, 1e-4, hv.size))
    for name, soup in (("neo", spec.neo), ("tactile", spec.tact)):
        x = pos[soup.tets[:n]]
        D = np.swapaxes(x[:, :3] - x[:, 3:4], 1, 2)
        out[name] = (D, soup.B[:n], soup.W[:n], rng.uniform(1e5, 2e5, len(D)),
                     rng.uniform(1e5, 3e5, len(D)))
    dx = 0.1 / 8
    rel = np.zeros((n, 3, 3))
    rel[:, 0] = [dx, 0, 0]
    rel[:, 1] = [0, dx, 0]
    rel[:, 2] = [dx / 3, dx / 3, 0]
    rel += 1e-3 * rng.normal(size=rel.shape)
    rel[:, 2, 2] = rng.uniform(-EPS_CONTACT, 2 * EPS_CONTACT, n)
    out["barrier"] = (rel,)
    return out


ENERGIES = {
    "membrane": (jen.membrane_energy, en.membrane_energy),
    "bending": (jen.bending_energy, en.bending_energy),
    "neo": (jen.neo_energy, en.neo_energy),
    "tactile": (jen.tactile_energy, en.tactile_energy),
    "barrier": (lambda r: jen.barrier_energy(r, K_CONTACT, EPS_CONTACT),
                lambda r: en.barrier_energy(r, K_CONTACT, EPS_CONTACT)),
}


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name", list(ENERGIES))
def test_value_grad_hess_match_jax(inputs, name):
    jfn, tfn = ENERGIES[name]
    args = inputs[name]
    want = jax.jit(jax.vmap(jspd.value_grad_hess(jfn)))(
        *(jnp.asarray(a) for a in args))
    got = torch.func.vmap(spd.value_grad_hess(tfn))(
        *(torch.as_tensor(a) for a in args))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float64
        _close(g, w)
    # the batched call gives the same per-element energies
    _close(tfn(*(torch.as_tensor(a) for a in args)), want[0])


@pytest.mark.parametrize("name", list(ENERGIES))
def test_float32_stays_float32(inputs, name):
    """AD of a float32 energy gives float32 gradients and Hessians."""
    _jfn, tfn = ENERGIES[name]
    args = [torch.as_tensor(a, dtype=torch.float32) for a in inputs[name]]
    for out in torch.func.vmap(spd.value_grad_hess(tfn))(*args):
        assert out.dtype == torch.float32


def test_hinge_angle_and_membrane_hessian_match_jax(inputs):
    x, sel = inputs["bending"][:2]
    _close(en.hinge_angle(torch.as_tensor(x), torch.as_tensor(sel)),
           jax.vmap(jen.hinge_angle)(jnp.asarray(x), jnp.asarray(sel)))
    args = inputs["membrane"]
    _close(elements.membrane_hess_closed(*(torch.as_tensor(a) for a in args)),
           jelements.membrane_hess_closed(*(jnp.asarray(a) for a in args)))


def test_friction_mollifier_and_inertia_match_jax():
    rng = np.random.default_rng(1)
    eps_v, h = 1e-2, 5e-3
    r = np.concatenate([rng.uniform(0, eps_v * h, 32),
                        rng.uniform(eps_v * h, 4 * eps_v * h, 32)])
    _close(en.f0_smooth(torch.as_tensor(r), eps_v, h),
           jen.f0_smooth(jnp.asarray(r), eps_v, h))
    NV = 50
    pos, prev, vel, ext = (rng.normal(size=(NV, 3)) for _ in range(4))
    mass = rng.uniform(0.5, 2.0, NV)
    g = np.array([0.0, 0.0, -9.8])
    args = (pos, prev, vel, mass, g, ext)
    want_e, want_g = jax.value_and_grad(jen.inertia_external_energy)(
        *(jnp.asarray(a) for a in args), 5e-3)
    tpos = torch.as_tensor(pos)
    got_g, got_e = torch.func.grad_and_value(en.inertia_external_energy)(
        tpos, *(torch.as_tensor(a) for a in args[1:]), 5e-3)
    _close(got_e, want_e)
    _close(got_g, want_g)


@pytest.mark.parametrize("k", [2, 9, 12])
def test_spd_projections_match_jax(k):
    rng = np.random.default_rng(k)
    H = rng.normal(size=(200, k, k))
    H = H + np.swapaxes(H, 1, 2) + rng.normal(0, 0.1, size=(200, k, k))
    if k == 2:
        got = spd.project_psd_2x2(torch.as_tensor(H))
        want = jspd.project_psd_2x2(jnp.asarray(H))
        # projected blocks are PSD
        assert torch.linalg.eigvalsh(got).min() > -1e-12
    else:
        got = spd.gershgorin_psd(torch.as_tensor(H))
        want = jspd.gershgorin_psd(jnp.asarray(H))
    _close(got, want)
    # the eigenvalue clamp (spd_method 'eigh', the scenes' default)
    got = spd.project_psd_method(torch.as_tensor(H), "eigh")
    _close(got, jspd.project_psd_method(jnp.asarray(H), "eigh"))
    assert torch.linalg.eigvalsh(got).min() > -1e-12
