"""The port's task scenes against the JAX package's, built live on the
CPU in f64, with no simulation: every maker's spec, initial state and
parameters (card's rotated pads, the forming and bouncing rest angles
included), every reward and adjoint seed on seeded random tapes, the
registry, the bundled balancing state, a checkpoint round trip, and the
host CMA-ES strategy's ask/tell sequence. Tolerance 1e-12 (the
strategy's sequence bit for bit)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.scenes import balancing as jbalancing
from thinshelllab_tpu.scenes import registry as jregistry
from thinshelllab_tpu.train.cmaes import CMAES as JCMAES
from thinshelllab_tpu.utils import checkpoint as jcheckpoint
from thinshelllab_torch.core import convert
from thinshelllab_torch.scenes import balancing, registry
from thinshelllab_torch.train.cmaes import CMAES
from thinshelllab_torch.utils import checkpoint
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

NEW = ["lifting", "sliding", "card", "pick", "forming", "balancing",
       "bouncing", "interact"]


def _leaves(obj, path=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        p = f"{path}.{f.name}"
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, p)
        else:
            yield p, v


def _assert_close(ours, ref):
    """Every array leaf of the same dtype and shape, floats within 1e-12
    and the rest equal; every static field equal (dtypes and the SpMV
    route under the port's names)."""
    got, want = dict(_leaves(ours)), dict(_leaves(ref))
    assert got.pop(".dev", None) is None and want.pop(".dev", None) is None
    assert got.keys() == want.keys()
    for p, w in want.items():
        g = got[p]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), p
            assert g.dtype == w.dtype and g.shape == w.shape, p
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-12,
                                           err_msg=p)
            else:
                np.testing.assert_array_equal(g, w, err_msg=p)
        elif p.endswith(".dtype"):
            assert g == convert.torch_dtype(w), p
        elif p.endswith(".spmv"):
            assert g == {"auto": "auto", "pallas": "kernel",
                         "xla": "plain"}[w], p
        else:
            assert g == w, (p, g, w)


@pytest.fixture(scope="module", params=NEW)
def pair(request):
    name = request.param
    return (name, registry.make_scene(name, solver="auto"),
            jregistry.make_scene(name, solver="auto"))


def test_scene_build_matches_jax(pair):
    name, sc, jsc = pair
    for a, b in ((sc.spec, jsc.spec), (sc.state0, jsc.state0),
                 (sc.params, jsc.params)):
        _assert_close(a, b)
    assert sc.spec.solver == "dense" and sc.spec.dia is None
    assert (sc.name, sc.n_part, sc.sys_param, sc.max_moving_dist) == (
        jsc.name, jsc.n_part, jsc.sys_param, jsc.max_moving_dist)
    assert sorted(sc.rewards) == sorted(jsc.rewards)
    assert sorted(sc.seed_losses) == sorted(jsc.seed_losses)
    if name == "card":
        # the two side pads start rotated +-90 deg about y
        s2 = np.sqrt(2.0) * 0.5
        np.testing.assert_array_equal(sc.state0.gripper.rot[:2],
                                      [[s2, 0, s2, 0], [s2, 0, -s2, 0]])
    if name == "bouncing":
        # the 1.7 rad plastic arch
        assert np.abs(sc.state0.ref_angle).max() == 1.7


def _random_tape(sc, T=4, seed=0):
    rng = np.random.default_rng(seed)
    NH = sc.spec.cloth.hinge_verts.shape[0]
    pos = (np.asarray(sc.state0.pos)[None]
           + 1e-3 * rng.normal(size=(T, sc.spec.NV, 3)))
    return {"pos": pos, "ref_angle": rng.normal(size=(T, NH))}


def test_rewards_and_seeds_match_jax(pair):
    """Every reward variant, and the seed `seed_for` gives it, on a seeded
    random tape."""
    name, sc, jsc = pair
    tape = _random_tape(sc)
    buf = {k: torch.as_tensor(v) for k, v in tape.items()}
    jbuf = {k: jnp.asarray(v) for k, v in tape.items()}
    for r in jsc.rewards:
        got = float(sc.reward(buf, r))
        want = float(jsc.reward(jbuf, r))
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (name, r)
        for got, want in zip(sc.seed_for(r)(buf), jsc.seed_for(r)(jbuf)):
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-12, err_msg=r)
    assert registry.resolve_reward(sc, None) is sc.rewards["default"]


def test_scene_attributes():
    pk = registry.make_scene("pick")
    assert pk.seed_loss_pick_fold is pk.seed_for("compute_reward_pick_fold")
    bl = registry.make_scene("throwing")
    assert bl.seed_loss_throwing is bl.seed_for("compute_reward_throwing")
    ia = registry.make_scene("interact")
    acts = (torch.zeros(8, 1, 3), torch.zeros(8, 1, 3), torch.zeros(8, 1))
    closed = ia.grip_close_actions(acts)[2]
    assert torch.equal(closed[:5, 0], torch.full((5,), -0.0006))
    assert torch.equal(closed[5:], torch.zeros(3, 1))
    assert torch.equal(acts[2], torch.zeros(8, 1))  # the input is kept


def test_registry_matches_jax():
    assert sorted(registry.SCENES) == sorted(jregistry.SCENES)
    for alias, target in (("separating", "sliding"), ("pick_fold", "pick"),
                          ("balance", "balancing"), ("throwing", "balancing")):
        assert registry.SCENES[alias] is registry.SCENES[target]
    with pytest.raises(KeyError) as ours:
        registry.make_scene("nope")
    with pytest.raises(KeyError) as ref:
        jregistry.make_scene("nope")
    assert str(ours.value) == str(ref.value)
    with pytest.raises(KeyError, match="has no reward"):
        registry.resolve_reward(registry.make_scene("bouncing"), "x")


def test_bundled_state_matches_jax(tmp_path):
    """The port's copy of the pre-grasped state loads as the JAX package's
    does; a save/load round trip keeps every leaf; float leaves take the
    asked dtype, the projection state stays int32."""
    st = checkpoint.load_state(balancing.bundled_state_path(),
                               torch.float64, "cpu")
    ref = jcheckpoint.load_state(jbalancing.bundled_state_path())
    got, want = dict(_leaves(st)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    for p, w in want.items():
        assert got[p].device.type == "cpu", p
        np.testing.assert_array_equal(got[p].numpy(), w, err_msg=p)
        assert got[p].numpy().dtype == w.dtype, p
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(st, path)
    back = jcheckpoint.load_state(path)
    for p, w in dict(_leaves(back)).items():
        np.testing.assert_array_equal(w, want[p], err_msg=p)
    f32 = checkpoint.load_state(path, torch.float32, "cpu")
    assert f32.pos.dtype == torch.float32 and f32.proj_flag.dtype == \
        torch.int32
    sc = registry.make_scene("balancing")
    assert st.pos.shape == sc.state0.pos.shape
    assert st.proj_flag.shape == sc.state0.proj_flag.shape


def test_load_state_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        checkpoint.load_state(balancing.bundled_state_path())


@pytest.mark.parametrize("dim,pop", [(1, 4), (5, 8)])
def test_cmaes_matches_jax(dim, pop):
    """Three generations of ask/tell with a fixed fitness, bit for bit; the
    third continues from a JAX state carried across."""
    def fit(X):
        return np.sum((X - 0.3) ** 2, axis=1) + 0.1 * X[:, 0]

    x0 = np.linspace(-1.0, 1.0, dim)
    je, pe = JCMAES(x0, 0.5, popsize=pop, seed=3), CMAES(x0, 0.5,
                                                         popsize=pop, seed=3)
    for _ in range(2):
        JX, X = je.ask(), pe.ask()
        np.testing.assert_array_equal(X, JX)
        je.tell(JX, fit(JX))
        pe.tell(X, fit(X))
    carried = convert.cmaes_from_reference(je)
    for es in (pe, carried):
        for key in ("mean", "C", "B", "D", "pc", "ps", "best_x"):
            np.testing.assert_array_equal(getattr(es, key), getattr(je, key))
        assert (es.sigma, es.gen, es.best_f) == (je.sigma, je.gen, je.best_f)
    JX = je.ask()
    for es in (pe, carried):
        X = es.ask()
        np.testing.assert_array_equal(X, JX)
        es.tell(X, fit(X))
    je.tell(JX, fit(JX))
    for es in (pe, carried):
        np.testing.assert_array_equal(es.mean, je.mean)
        assert es.sigma == je.sigma
        np.testing.assert_array_equal(es.result.xbest, je.result.xbest)


def test_params_of_the_system_id_scenes():
    """The leaves the dp drivers read: sliding's friction slot 0 (of
    three) and card's first cloth's kb (of three cloths)."""
    from thinshelllab_torch.train import dp

    sl = registry.make_scene("sliding")
    assert sl.params.mu_pairs.shape == (3,)
    assert float(dp._get_param(sl.params, "mu_pair:0")) == 0.5
    cd = registry.make_scene("card", kb=123.0)
    assert cd.params.kb.shape == (3,)
    _, _, params = cd.to("cpu")
    moved = dp._set_param(params, "kb", 7.0)
    assert moved.kb.tolist() == [7.0, 123.0, 123.0]
    assert params.kb.tolist() == [123.0, 123.0, 123.0]
    with pytest.raises(KeyError):
        dp._get_param(params, "E")


def test_grasped_state_closes_the_gripper():
    """make_grasped_state's first step on the CPU: the paired gripper
    closes by close_dist / close_steps, the state stays finite."""
    sc = registry.make_scene("balancing", max_newton_iter=1)
    st = balancing.make_grasped_state(sc, close_steps=1, settle_steps=0,
                                      device="cpu")
    assert torch.equal(st.gripper.dist,
                       torch.full((2,), -0.002, dtype=torch.float64))
    assert bool(torch.isfinite(st.pos).all())


def test_eigh_refusal_falls_back_to_the_host(monkeypatch):
    """Nothing falls back to the host: float32 blocks are decomposed in
    float64 on their own device and cast back; a refusal, or a non-finite
    result, for finite blocks raises; non-finite blocks give NaN, as the
    JAX package's eigh does."""
    from thinshelllab_torch.ops import spd

    g = torch.Generator().manual_seed(0)
    A = torch.randn((16, 9, 9), generator=g, dtype=torch.float32)
    want = spd.project_psd(A.double())
    eigh, calls = torch.linalg.eigh, []

    def record(h):
        calls.append((h.device, h.dtype))
        return eigh(h)

    monkeypatch.setattr(torch.linalg, "eigh", record)
    got = spd.project_psd(A)
    assert calls == [(A.device, torch.float64)]
    assert got.dtype == torch.float32
    assert float((got.double() - want).abs().max()) <= (
        1e-5 * float(want.abs().max()))

    def refuse(h):
        raise torch.linalg.LinAlgError("did not converge")

    def nan(h):
        w, v = eigh(h)
        return w, v * float("nan")

    for fault in (refuse, nan):
        monkeypatch.setattr(torch.linalg, "eigh", fault)
        with pytest.raises(torch.linalg.LinAlgError):
            spd.project_psd(A)
    B = A.clone()
    B[3, 0, 0] = float("nan")
    for fault in (refuse, nan):
        monkeypatch.setattr(torch.linalg, "eigh", fault)
        assert bool(torch.isnan(spd.project_psd(B)).all())
