"""The element layer's two kernels (ops/element_kernels.py,
csrc/elements.cu) against the plain torch.func route of
engine/elements.all_groups.

On the CPU (tier-1): csrc/elements.cu built with g++ runs the kernels'
per-item arithmetic (the hyper-dual energies, the friction's closed form,
the fuse's layouts) in host loops, held against all_groups' own route on
the small folding scene at a pressed state of the JAX package's saved
rollout (tests/data/folding_reference_golden.npz), jittered so that its
active contacts slip in both friction regimes, with 153 masked hinges; and
the wrappers' checks, which run before any library loads.

On the card (marker `cuda`; skips without one): the kernel route of
all_groups against `elements.plain_groups` on the same CUDA inputs. This
file imports no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_element_kernels.py
"""
import os

import numpy as np
import pytest
import torch

from thinshelllab_torch.engine import adjoint, elements, stepper
from thinshelllab_torch.ops import element_kernels as ek
from thinshelllab_torch.scenes import bench_scene, folding

import _element_host
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "folding_reference_golden.npz")
# kernel vs plain: the same energies differentiated another way (hyper-dual
# forward mode against reverse-over-forward AD) and summed in another
# order, max |kernel - plain| / max |plain| over the fused array. f64 keeps
# ~16 digits; in f32 the membrane's gradient is a sum of edge tensions that
# cancel to a few per cent of each, so both routes sit ~1e-5 of the largest
# gradient from the f64 value, ~6e-6 apart on this state.
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
SPD = [(True, "eigh"), (True, "shift"), (False, "eigh")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rel(got, want):
    want = want.detach().cpu()
    scale = float(want.abs().max())
    err = float((got.detach().cpu() - want).abs().max())
    return err / (scale if scale > 0 else 1.0)


def pressed_folding(device, dtype, spd_method="eigh", bend_batch=False):
    """The small folding scene at step 4 of the saved pressing rollout,
    its contact set there, and each vertex moved by a random 1e-7..1e-4 m:
    (spec, params, pos, ref_angle, contact)."""
    sc = folding.make(table_n=4, max_newton_iter=30)
    spec, s0, params = sc.to("cpu", dtype)
    spec = spec.replace(spd_method=spd_method, bend_batch=bend_batch)
    with np.load(GOLDEN) as g:
        P = torch.as_tensor(g["buf.pos"], dtype=dtype)
        ref = torch.as_tensor(g["buf.ref_angle"][4], dtype=dtype)
    contact, _, _ = stepper.build_contacts(spec, params, P[4], P[3],
                                           s0.proj_flag, s0.proj_dir)
    rng = np.random.default_rng(0)
    jit = rng.normal(size=(spec.NV, 3)) * 10.0 ** rng.uniform(
        -7, -4, size=(spec.NV, 1))
    pos = P[4] + torch.as_tensor(jit, dtype=dtype) * spec.dev.unf
    if device.type != "cpu":
        spec, s0, params = sc.to(device, dtype)
        spec = spec.replace(spd_method=spd_method, bend_batch=bend_batch)
        contact = contact.to(device, dtype)
        pos, ref = pos.to(device), ref.to(device)
    return spec, params, pos, ref, contact


def pressed_tape(device, dtype):
    """The small folding scene in dtype and the saved pressing rollout's
    tape (T=5) in dtype on device: (scene, spec, params, buffers)."""
    sc = folding.make(table_n=4, max_newton_iter=30)
    spec, _s0, params = sc.to(device, dtype)
    with np.load(GOLDEN) as g:
        buf = {k[4:]: torch.as_tensor(
            g[k], dtype=dtype if g[k].dtype == np.float64 else None)
            for k in g.files if k.startswith("buf.")}
    return sc, spec, params, {k: v.to(device) for k, v in buf.items()}


def backward_on_route(route, spec, params, buf, seeds, **kw):
    """adjoint.backward with all_groups(with_hess=True) taken by `route`
    (a function of all_groups' Hessian arguments)."""
    orig = elements.all_groups

    def groups(spec, params, pos, ref, contact, with_hess=True, spd=True):
        if not with_hess:
            return orig(spec, params, pos, ref, contact, False, spd)
        return route(spec, params, pos, ref, contact, spd)

    elements.all_groups = groups
    try:
        return adjoint.backward(spec, params, buf, *seeds, **kw)
    finally:
        elements.all_groups = orig


def _assert_fused_close(got, want, dtype):
    assert torch.equal(got["idx"].cpu(), want["idx"].cpu())
    assert set(got) == {"idx", "g", "H"}
    for k in ("g", "H"):
        assert got[k].dtype == dtype and got[k].shape == want[k].shape
        assert _rel(got[k], want[k]) < RTOL[dtype], k


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------


def test_pressed_state_covers_every_branch():
    """The state the host-build tests use: active contacts in both friction
    regimes (r > eps_v dt and r <= eps_v dt), masked hinges, both tet
    families."""
    spec, _params, pos, _ref, contact = pressed_folding(
        torch.device("cpu"), torch.float64)
    _u, r = elements.friction_slip(spec, contact, pos[contact.idx])
    eh = spec.eps_v * spec.dt
    act = contact.active
    assert int((act & (r > eh)).sum()) >= 2
    assert int((act & (r <= eh)).sum()) >= 2
    assert int((~spec.cloth.hinge_mask).sum()) > 0
    assert spec.neo.tets.shape[0] > 0 and spec.tact.tets.shape[0] > 0


@pytest.mark.parametrize("spd_on,method", SPD,
                         ids=["eigh", "shift", "no-spd"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_host_build_matches_plain(dtype, spd_on, method):
    """The kernels' arithmetic and layouts, compiled for the host, against
    all_groups on CPU tensors, with and without the projections."""
    spec, params, pos, ref, contact = pressed_folding(
        torch.device("cpu"), dtype, method)
    want = elements.all_groups(spec, params, pos, ref, contact,
                               with_hess=True, spd=spd_on)
    got, _ = _element_host.groups(spec, params, pos, ref, contact, spd_on)
    _assert_fused_close(got, want, dtype)


def test_host_build_energies_match_plain():
    """element_eval's per-element energies (the diagonal threads' values)
    against the energies of ops/energies.py, family by family."""
    from thinshelllab_torch.ops import energies as en

    spec, params, pos, ref, contact = pressed_folding(torch.device("cpu"),
                                                      torch.float64)
    _, b = _element_host.groups(spec, params, pos, ref, contact, True)
    c = spec.cloth
    soups = elements.gather_soups(spec, contact, pos)
    kl, ka = elements._face_params(spec, params)
    want = {
        "em": en.membrane_energy(soups["xm"], c.l0, c.rest_area, kl, ka),
        "eb": en.bending_energy(soups["xb"], c.hinge_sel, ref, c.hinge_coef,
                                params.kb[c.hinge_cloth]) * spec.dev.hinge_m,
        "en": en.neo_energy(elements._tet_D(soups["xn"]), spec.neo.B,
                            spec.neo.W, params.neo_mu[spec.neo.group],
                            params.neo_lam[spec.neo.group]),
        "et": en.tactile_energy(elements._tet_D(soups["xt"]), spec.tact.B,
                                spec.tact.W, params.tact_mu[spec.tact.group],
                                params.tact_lam[spec.tact.group]),
        "ec": en.barrier_energy(elements._rel_R(soups["xc"]), spec.k_contact,
                                spec.eps_contact),
        "ef": contact.k * en.f0_smooth(
            elements.friction_slip(spec, contact, soups["xc"])[1],
            spec.eps_v, spec.dt),
    }
    for k, w in want.items():
        assert _rel(b[k], w) < RTOL[torch.float64], k


def test_host_build_takes_one_hinge_form_under_bend_batch():
    """With spec.bend_batch the plain route's gradient is the batch form's;
    the kernels' per-hinge form agrees with it to rounding."""
    spec, params, pos, ref, contact = pressed_folding(
        torch.device("cpu"), torch.float64, bend_batch=True)
    want = elements.all_groups(spec, params, pos, ref, contact)
    got, _ = _element_host.groups(spec, params, pos, ref, contact, True)
    _assert_fused_close(got, want, torch.float64)


# kernel vs plain in the adjoint's gripper gradient of a float32 scene
# solved in float64, max |kernel - plain| / max |plain|: the Hessians
# differ at ~1e-15 of their scale and the gradient is gathered in float32
# (chain float32 or float64), so the two may part by a few float32
# roundings. The float32 solve's gradient sits ~4e-4 from the float64
# solve's on this tape. On the card a float32 chain sums its index_adds
# with atomics, in an order of its own each run, and the sweep carries
# those roundings on: the two routes' gradients parted by 4.3e-5 there
# (H100), so the card's float32 chain is held at 2e-4 and its Hessians,
# which see the same tape on both routes, at RTOL.
SOLVE_DTYPE_RTOL = 1e-5
CARD_F32_CHAIN_RTOL = 2e-4


@pytest.mark.parametrize("chain", [None, torch.float64],
                         ids=["chain-f32", "chain-f64"])
def test_host_build_backward_in_a_wider_solve_dtype(chain):
    """adjoint.backward(solve_dtype=float64) on a float32 scene builds its
    Hessians from the spec cast to float64, so that the kernels' route
    sees one float dtype: through the host build it gives the plain
    route's gradient, apart from the float32 solve's."""
    sc, spec, params, buf = pressed_tape(torch.device("cpu"), torch.float32)
    seeds = sc.seed_loss(buf)
    kw = dict(solve_dtype=torch.float64, chain_dtype=chain)
    want = adjoint.backward(spec, params, buf, *seeds, **kw)
    got = backward_on_route(lambda *a: _element_host.groups(*a)[0], spec,
                            params, buf, seeds, **kw)
    f32 = adjoint.backward(spec, params, buf, *seeds, chain_dtype=chain)
    assert got.gripper_grad.dtype == want.gripper_grad.dtype
    assert _rel(f32.gripper_grad, want.gripper_grad) > 10 * SOLVE_DTYPE_RTOL
    assert _rel(got.gripper_grad, want.gripper_grad) < SOLVE_DTYPE_RTOL


def test_cpu_route_launches_nothing():
    """CPU tensors take the torch.func route: no launch is counted, and the
    fused group is plain_groups' own."""
    spec, params, pos, ref, contact = pressed_folding(torch.device("cpu"),
                                                      torch.float64)
    ek.reset_launches()
    got = elements.all_groups(spec, params, pos, ref, contact)
    assert ek.LAUNCHES == {"element_eval": 0, "element_fuse": 0}
    want = elements.plain_groups(spec, params, pos, ref, contact)
    for k in ("idx", "g", "H"):
        assert torch.equal(got[k], want[k])


def _bad_inputs(case):
    spec, params, pos, ref, contact = pressed_folding(torch.device("cpu"),
                                                      torch.float64)
    if case == "requires_grad":
        pos = pos.clone().requires_grad_(True)
    elif case == "params_require_grad":
        params = params.replace(kb=params.kb.clone().requires_grad_(True))
    elif case == "half":
        pos = pos.half()
    elif case == "mixed":
        pos = pos.float()
    elif case == "index_int32":
        contact = contact.replace(idx=contact.idx.int())
    elif case == "strided":
        pos = pos.T.contiguous().T
    elif case == "strided_contact":
        contact = contact.replace(w=contact.w.T.contiguous().T)
    return spec, params, pos, ref, contact


@pytest.mark.parametrize("case,match", [
    ("requires_grad", "requires grad"),
    ("params_require_grad", "requires grad"),
    ("half", "float32/float64"),
    ("mixed", "expected torch.float32"),
    ("index_int32", "expected torch.int64"),
    ("strided", "contiguous"),
    ("strided_contact", "contiguous"),
    ("cpu", "CUDA tensors"),
])
def test_wrapper_checks_raise_before_loading(case, match):
    """element_eval refuses what the kernels do not take, before a library
    is built or loaded; valid CPU tensors are refused for want of a card."""
    args = _bad_inputs(case)
    ek.reset_launches()
    with pytest.raises(ValueError, match=match):
        ek.element_eval(*args, True)
    assert ek.LAUNCHES == {"element_eval": 0, "element_fuse": 0}


def test_fuse_checks_its_blocks():
    """element_fuse refuses blocks of another shape or dtype than
    element_eval writes, and CPU blocks."""
    spec, params, pos, ref, contact = pressed_folding(torch.device("cpu"),
                                                      torch.float64)
    _, blocks = ek.eval_args(spec, params, pos, ref, contact, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ek.element_fuse(spec, contact, dict(blocks))
    bad = dict(blocks, Hb=blocks["Hb"][:, :9, :9].contiguous())
    with pytest.raises(ValueError, match="shape"):
        ek.element_fuse(spec, contact, bad)
    bad = dict(blocks, Hr=blocks["Hr"].float())
    with pytest.raises(ValueError, match="expected torch.float64"):
        ek.element_fuse(spec, contact, bad)


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("spd_on,method", SPD,
                         ids=["eigh", "shift", "no-spd"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernels_match_plain_on_folding(cuda, dtype, spd_on, method):
    """all_groups on the card (two launches) against plain_groups on the
    same CUDA inputs."""
    spec, params, pos, ref, contact = pressed_folding(cuda, dtype, method)
    ek.reset_launches()
    got = elements.all_groups(spec, params, pos, ref, contact,
                              with_hess=True, spd=spd_on)
    torch.cuda.synchronize()
    assert ek.LAUNCHES == {"element_eval": 1, "element_fuse": 1}
    want = elements.plain_groups(spec, params, pos, ref, contact, spd_on)
    _assert_fused_close(got, want, dtype)


@pytest.mark.cuda
def test_kernels_match_plain_under_bend_batch(cuda):
    spec, params, pos, ref, contact = pressed_folding(
        cuda, torch.float64, bend_batch=True)
    got = elements.all_groups(spec, params, pos, ref, contact)
    want = elements.plain_groups(spec, params, pos, ref, contact)
    _assert_fused_close(got, want, torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernels_match_plain_on_a_large_cloth(cuda, dtype):
    """The bench cloth at cloth_N=70 (29,400 hinges: 2.3M bending items,
    past the 4096 blocks x 128 threads a family launches), jittered, its
    contact set built on the card: the grid-stride path."""
    sc = bench_scene.make(cloth_N=70, table_n=12, dtype=torch.float64)
    spec, s0, params = sc.to(cuda, dtype)
    assert spec.cloth.hinge_verts.shape[0] >= 10_000
    g = torch.Generator().manual_seed(0)
    pos = s0.pos + 1e-4 * torch.randn(s0.pos.shape, generator=g,
                                      dtype=torch.float64).to(cuda, dtype)
    contact, _, _ = stepper.build_contacts(spec, params, pos, pos,
                                           s0.proj_flag, s0.proj_dir)
    ek.reset_launches()
    got = elements.all_groups(spec, params, pos, s0.ref_angle, contact)
    assert ek.LAUNCHES == {"element_eval": 1, "element_fuse": 1}
    want = elements.plain_groups(spec, params, pos, s0.ref_angle, contact)
    _assert_fused_close(got, want, dtype)


@pytest.mark.cuda
def test_kernel_route_refuses_autograd_inputs(cuda):
    spec, params, pos, ref, contact = pressed_folding(cuda, torch.float64)
    with pytest.raises(ValueError, match="requires grad"):
        elements.all_groups(spec, params, pos.clone().requires_grad_(True),
                            ref, contact)


@pytest.mark.cuda
def test_newton_step_launches_two_kernels_an_iteration(cuda):
    """One f64 step of the small folding scene on the card: every Newton
    iteration's all_groups(with_hess=True) goes through the two kernels."""
    sc = folding.make(table_n=4, max_newton_iter=30)
    spec, s0, params = sc.to(cuda, torch.float64)
    acts = (torch.tensor([[[0.0, 0.0, -3e-4]]], dtype=torch.float64,
                         device=cuda),
            torch.zeros((1, 1, 3), dtype=torch.float64, device=cuda),
            torch.zeros((1, 1), dtype=torch.float64, device=cuda))
    ek.reset_launches()
    stats = {}
    _, buf = stepper.simulate(spec, params, s0, acts, stats=stats)
    n = stats["hess_builds"]
    assert n > 0 and bool(torch.isfinite(buf["pos"]).all())
    assert ek.LAUNCHES == {"element_eval": n, "element_fuse": n}


@pytest.mark.cuda
@pytest.mark.parametrize("chain", [None, torch.float64],
                         ids=["chain-f32", "chain-f64"])
def test_kernels_backward_in_a_wider_solve_dtype(cuda, chain):
    """adjoint.backward(solve_dtype=float64) on a float32 scene on the
    card: its Hessians go through the two kernels (one call a step) in
    float64, equal to the plain route's on the same tape, and the gradient
    is the plain route's."""
    sc, spec, params, buf = pressed_tape(cuda, torch.float32)
    seeds = sc.seed_loss(buf)
    kw = dict(solve_dtype=torch.float64, chain_dtype=chain)
    all_groups = elements.all_groups
    kernel, plain = [], []

    def recorded(fn, out):
        def route(*args):
            out.append(fn(*args))
            return out[-1]
        return route

    ek.reset_launches()
    got = backward_on_route(
        recorded(lambda *a: all_groups(*a[:5], True, a[5]), kernel), spec,
        params, buf, seeds, **kw)
    T = buf["pos"].shape[0]
    assert ek.LAUNCHES == {"element_eval": T - 1, "element_fuse": T - 1}
    want = backward_on_route(recorded(elements.plain_groups, plain), spec,
                             params, buf, seeds, **kw)
    assert len(kernel) == len(plain) == T - 1
    for k, p in zip(kernel, plain):
        _assert_fused_close(k, p, torch.float64)
    assert got.gripper_grad.dtype == want.gripper_grad.dtype
    assert float(want.gripper_grad.abs().max()) > 0
    tol = CARD_F32_CHAIN_RTOL if chain is None else SOLVE_DTYPE_RTOL
    assert _rel(got.gripper_grad, want.gripper_grad) < tol
