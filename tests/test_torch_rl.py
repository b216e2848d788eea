"""The port's RL layer against the JAX package's, in f64 on the CPU.

- Environments against the JAX package's saved runs (rl_golden.npz), on
  folding at `table_n=4` with `max_newton_iter=5`: `Env("folding", ...)`
  (the reference env's kb=100, mu=1) reset and 3 steps into its time
  limit; `EvalEnv` 2 steps; `BatchedEnv(n=2)` with a time limit of 3 and
  env 1 started at t=1, 3 steps in which env 0 stops early on the force
  bound, env 1 reaches its time limit, and both auto-reset. Observations
  within 1e-9 m (each state's float64 observation; the float32 ones the
  envs return within one float32 rounding of it), rewards within 1e-9
  relative, done flags and episode times equal.
- One update of each trainer, from JAX parameters and Adam moments
  carried across after one JAX update, on seeded batches and (SAC) JAX's
  own noise draws, against the live jitted JAX update: every parameter,
  target and temperature within 1e-10. The recurrent policy's step with
  JAX's noise likewise; GAE against the JAX trainer's own loop (its
  captured batch); checkpoints read across both ways.
- The bandit-learning checks of tests/test_training.py, on the port.
- The stable-baselines3 branch of `cli rl` against in-file stub modules
  (tests/test_sb3_interop.py's contract), and `cli rl --platform cpu` for
  each `--algo`.

Regenerate the golden file (after a deliberate change of the reference):
    PYTHONPATH=. python tests/test_torch_rl.py
"""
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thinshelllab_tpu.train import ppo as jppo
from thinshelllab_tpu.train import recurrent_ppo as jrppo
from thinshelllab_tpu.train import sac as jsac
from thinshelllab_torch import cli
from thinshelllab_torch.core import convert
from thinshelllab_torch.scenes import folding, registry
from thinshelllab_torch.scenes.base import observation
from thinshelllab_torch.train import ppo, recurrent_ppo, sac
from thinshelllab_torch.train.rl_env import BatchedEnv, Env, EvalEnv
from _torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "rl_golden.npz")
SCENE_CFG = dict(table_n=4, max_newton_iter=5)
LIMIT = 3
OBS_ATOL = 1e-9
REWARD_RTOL = 1e-9
UPDATE_ATOL = 1e-10
F32_ULP = 2.0**-23


def env_actions():
    a = np.zeros((LIMIT, 6))
    a[:, 0], a[:, 2], a[:, 4] = 1e-4, -6e-4, 2e-3
    return a


def eval_actions():
    a = np.zeros((2, 6))
    a[:, 2] = -1.2e-3
    return a


def batched_actions():
    """Env 0 presses 1.8 mm a step (the force bound stops it after its
    second step), env 1 0.5 mm with a tilt."""
    a = np.zeros((LIMIT, 2, 6))
    a[:, 0, 0], a[:, 0, 2] = 3e-4, -1.8e-3
    a[:, 1, 2], a[:, 1, 4] = -5e-4, 2e-3
    return a


BATCHED_T0 = np.array([0, 1])


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _check_obs(obs32, obs64, want32, want64):
    assert obs64.shape == want64.shape
    assert np.abs(obs64 - want64).max() <= OBS_ATOL
    assert obs32.dtype == np.float32
    np.testing.assert_array_equal(obs32, obs64.astype(np.float32))
    assert np.all(np.abs(obs32 - want32) <= F32_ULP * np.abs(want64)
                  + OBS_ATOL)


def _close(got, want, rtol=REWARD_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= rtol * np.abs(want)), (got, want)


def test_env_matches_jax(golden):
    env = Env("folding", time_step=LIMIT, device="cpu", **SCENE_CFG)
    assert float(env.scene.params.kb[0]) == 100.0
    obs, _ = env.reset()
    _check_obs(obs, observation(env.spec, env.state).numpy(),
               golden["env.obs0"], golden["env.obs64_0"])
    for t, a in enumerate(env_actions()):
        obs, rew, done, trunc, _ = env.step(a.astype(np.float32))
        obs64 = observation(env.spec, env.state).numpy()
        assert np.abs(obs64 - golden["env.obs64"][t]).max() <= OBS_ATOL
        want = golden["env.obs"][t]
        if done:
            assert not want.any() and not obs.any()
        else:
            _check_obs(obs, obs64, want, golden["env.obs64"][t])
        _close(rew, golden["env.rew"][t])
        assert (done, trunc) == (bool(golden["env.done"][t]),) * 2
    assert done and env.t == LIMIT


def test_eval_env_matches_jax(golden):
    env = EvalEnv("folding", time_step=LIMIT, device="cpu", **SCENE_CFG)
    env.reset()
    for t, a in enumerate(eval_actions()):
        obs, delta, done, _, _ = env.step(a)
        _check_obs(obs, observation(env.spec, env.state).numpy(),
                   golden["eval.obs"][t], golden["eval.obs64"][t])
        assert abs(delta - golden["eval.delta"][t]) <= REWARD_RTOL * max(
            1e-6, abs(golden["eval.delta"][t]))
        assert not done


def test_batched_env_matches_jax(golden):
    sc = registry.make_scene("folding", **SCENE_CFG)
    env = BatchedEnv(sc, 2, time_limit=LIMIT, device="cpu")
    obs = env.reset()
    assert obs.shape == (2, golden["env.obs0"].shape[0])
    env.t[:] = BATCHED_T0
    for t, a in enumerate(batched_actions()):
        obs, rew, done = env.step(a)
        obs64 = np.stack([observation(env.spec, s).numpy()
                          for s in env.states])
        _check_obs(obs, obs64, golden["batched.obs"][t],
                   golden["batched.obs64"][t])
        _close(rew, golden["batched.rew"][t])
        np.testing.assert_array_equal(done, golden["batched.done"][t])
        np.testing.assert_array_equal(env.t, golden["batched.t"][t])
    # env 0 stopped early, env 1 at its time limit, then both went on from
    # the initial state
    np.testing.assert_array_equal(golden["batched.done"],
                                  [[False, False], [True, True],
                                   [False, False]])


def test_envs_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = folding.make(**SCENE_CFG)
    for make in (lambda: Env(scene=sc), lambda: BatchedEnv(sc, 2),
                 lambda: ppo.PPOTrainer(_Stub())):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()


# ---------------------------------------------------------------- updates


class _Stub:
    """The BatchedEnv surface the trainers read at construction."""

    def __init__(self, n=3, obs_dim=5):
        self.n = n
        self.obs_dim = obs_dim
        self.scene = types.SimpleNamespace(n_part=1)

    def reset(self):
        return np.zeros((self.n, self.obs_dim), np.float32)


def _mlp_err(mlp, tree):
    return max(max(np.abs(lin.weight.detach().numpy().T - np.asarray(w)).max(),
                   np.abs(lin.bias.detach().numpy() - np.asarray(b)).max())
               for lin, (w, b) in zip(mlp.layers, tree, strict=True))


def _moment_err(opt, leaves, state):
    """Largest difference of the port's Adam moments from optax's."""
    count, mu, nu = convert._adam_moments(state)
    err = 0.0
    for (p, m), (_, v) in zip(leaves(mu), leaves(nu)):
        st = opt.state[p]
        assert int(st["step"]) == count
        err = max(err, np.abs(st["exp_avg"].numpy() - m).max(),
                  np.abs(st["exp_avg_sq"].numpy() - v).max())
    return err


def _ppo_batch(rng, B=12):
    return (rng.normal(size=(B, 5)).astype(np.float32),
            rng.normal(size=(B, 6)), rng.normal(size=B), rng.normal(size=B),
            rng.normal(size=B) - 5.0)


def test_ppo_update_matches_jax():
    rng = np.random.default_rng(0)
    jt = jppo.PPOTrainer(_Stub(), hidden=16, seed=3)
    s1 = jt._update(jt.state, tuple(map(jnp.asarray, _ppo_batch(rng))))
    batch = _ppo_batch(rng)
    s2 = jt._update(s1, tuple(map(jnp.asarray, batch)))
    pt = ppo.PPOTrainer(_Stub(), hidden=16, seed=3, device="cpu",
                        dtype=torch.float64)
    convert.ppo_from_reference(s1, pt)
    pt.update(batch)
    assert _mlp_err(pt.pi, s2.pi) <= UPDATE_ATOL
    assert _mlp_err(pt.vf, s2.vf) <= UPDATE_ATOL
    assert np.abs(pt.log_std.detach().numpy()
                  - np.asarray(s2.log_std)).max() <= UPDATE_ATOL

    def leaves(tree):
        return (convert._mlp_leaves(pt.pi, tree[0])
                + convert._mlp_leaves(pt.vf, tree[1])
                + [(pt.log_std, np.asarray(tree[2]))])

    assert _moment_err(pt.optimizer, leaves, s2.opt_state) <= UPDATE_ATOL
    # the policy step with JAX's noise, and the deterministic action
    obs = rng.normal(size=(3, 5)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ja, jl = jt._policy(s2.pi, s2.log_std, jnp.asarray(obs), key)
    noise = np.asarray(jax.random.normal(key, (3, 6)))
    with torch.no_grad():
        pa, pl = pt.policy(pt._t(obs), torch.tensor(noise))
    assert np.abs(pa.numpy() - np.asarray(ja)).max() <= UPDATE_ATOL
    assert np.abs(pl.numpy() - np.asarray(jl)).max() <= UPDATE_ATOL
    jt.state = s2
    assert np.abs(pt.act(obs) - jt.act(obs)).max() <= UPDATE_ATOL


def _sac_batch(rng, B=8):
    return (rng.normal(size=(B, 5)).astype(np.float32),
            rng.uniform(-1, 1, (B, 6)).astype(np.float32),
            rng.uniform(0, 2, B).astype(np.float32),
            rng.normal(size=(B, 5)).astype(np.float32),
            (rng.uniform(size=B) < 0.3).astype(np.float32))


def test_sac_update_matches_jax():
    rng = np.random.default_rng(1)
    B = 8
    jt = jsac.SACTrainer(_Stub(), hidden=16, seed=3, batch_size=B)
    s1 = jt._update(jt.state, tuple(map(jnp.asarray, _sac_batch(rng, B))),
                    jax.random.PRNGKey(7))
    batch, key = _sac_batch(rng, B), jax.random.PRNGKey(9)
    s2 = jt._update(s1, tuple(map(jnp.asarray, batch)), key)
    k1, k2 = jax.random.split(key)  # the JAX update's own split
    noise = [torch.tensor(np.asarray(jax.random.normal(k, (B, 6))))
             for k in (k1, k2)]
    pt = sac.SACTrainer(_Stub(), hidden=16, seed=3, batch_size=B,
                        device="cpu", dtype=torch.float64)
    convert.sac_from_reference(s1, pt)
    pt.update(batch, *noise)
    for mod, tree in ((pt.actor, s2.actor), (pt.q1, s2.q1), (pt.q2, s2.q2),
                      (pt.q1_targ, s2.q1_targ), (pt.q2_targ, s2.q2_targ)):
        assert _mlp_err(mod, tree) <= UPDATE_ATOL
    assert abs(pt.log_alpha.item() - float(s2.log_alpha)) <= UPDATE_ATOL
    assert float(s2.log_alpha) != float(s1.log_alpha)
    assert _moment_err(pt.actor_opt,
                       lambda t: convert._mlp_leaves(pt.actor, t),
                       s2.actor_opt) <= UPDATE_ATOL
    assert _moment_err(pt.q_opt, lambda t: (convert._mlp_leaves(pt.q1, t[0])
                                            + convert._mlp_leaves(pt.q2,
                                                                  t[1])),
                       s2.q_opt) <= UPDATE_ATOL
    # the squashed Gaussian with JAX's noise
    obs = jnp.asarray(batch[0])
    ja, jl, jm = jsac._squashed_gaussian(s2.actor, obs, k1)
    with torch.no_grad():
        pa, pl, pm = sac.squashed_gaussian(pt.actor, pt._t(batch[0]),
                                           noise[0])
    for got, want in ((pa, ja), (pl, jl), (pm, jm)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= UPDATE_ATOL


def _rppo_batch(rng, H=4, N=3, hidden=8):
    return (rng.normal(size=(H, N, 5)).astype(np.float32),
            rng.normal(size=(H, N, 6)), rng.normal(size=(H, N)),
            rng.normal(size=(H, N)), rng.normal(size=(H, N)) - 5.0,
            (rng.uniform(size=(H, N)) < 0.3).astype(np.float32),
            (rng.normal(size=(N, hidden)), rng.normal(size=(N, hidden))))


def test_recurrent_ppo_update_matches_jax():
    rng = np.random.default_rng(2)
    jt = jrppo.RecurrentPPOTrainer(_Stub(), hidden=8, seed=3)
    s1 = jt._update(jt.state, jax.tree.map(jnp.asarray, _rppo_batch(rng)))
    batch = _rppo_batch(rng)
    s2 = jt._update(s1, jax.tree.map(jnp.asarray, batch))
    pt = recurrent_ppo.RecurrentPPOTrainer(_Stub(), hidden=8, seed=3,
                                           device="cpu", dtype=torch.float64)
    convert.rppo_from_reference(s1, pt)
    pt.update(batch)
    lstm = pt.lstm.arrays()
    for got, want in zip(lstm, s2.lstm):
        assert np.abs(got - np.asarray(want)).max() <= UPDATE_ATOL
    assert _mlp_err(pt.pi, s2.pi) <= UPDATE_ATOL
    assert _mlp_err(pt.vf, s2.vf) <= UPDATE_ATOL
    assert np.abs(pt.log_std.detach().numpy()
                  - np.asarray(s2.log_std)).max() <= UPDATE_ATOL
    # one policy step with JAX's noise, from a carry
    obs = rng.normal(size=(3, 5)).astype(np.float32)
    carry = (rng.normal(size=(3, 8)), rng.normal(size=(3, 8)))
    key = jax.random.PRNGKey(4)
    jc, ja, jl, jv = jt._fwd_step_fn(s2, jnp.asarray(obs),
                                     tuple(map(jnp.asarray, carry)), key)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (3, 6))))
    with torch.no_grad():
        pc, pa, pl, pv = pt.fwd_step(pt._t(obs), tuple(map(pt._t, carry)),
                                     noise)
    for got, want in ((pc[0], jc[0]), (pc[1], jc[1]), (pa, ja), (pl, jl),
                      (pv, jv)):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= UPDATE_ATOL
    jt.state = s2
    (pa, pcarry), (ja, jcarry) = pt.act(obs), jt.act(obs)
    assert np.abs(pa - ja).max() <= UPDATE_ATOL
    assert np.abs(pcarry[0].numpy() - np.asarray(jcarry[0])).max() \
        <= UPDATE_ATOL


class _EpisodeEnv(_Stub):
    """Deterministic episodes for the GAE check: observations, rewards and
    done flags that depend only on the step count."""

    def __init__(self):
        super().__init__(n=3, obs_dim=5)
        self.k = 0

    def step(self, act):
        self.k += 1
        rng = np.random.default_rng(self.k)
        done = rng.uniform(size=self.n) < 0.3
        return (rng.normal(size=(self.n, self.obs_dim)).astype(np.float32),
                rng.uniform(0.5, 1.5, self.n), done)


def test_gae_matches_jax_loop(monkeypatch):
    H = 7
    env = _EpisodeEnv()
    jt = jppo.PPOTrainer(env, total_steps=H * env.n, horizon=H, epochs=1,
                         minibatches=1, hidden=8, seed=0)
    captured = []
    monkeypatch.setattr(jt, "_update",
                        lambda state, batch: captured.append(batch) or state)
    monkeypatch.setattr(np.random, "shuffle", lambda idx: None)
    jt.train(verbose=False)
    obs, _, adv_j, ret_j, _ = (np.asarray(b) for b in captured[0])
    val = np.asarray(jppo._mlp_apply(jt.state.vf,
                                     jnp.asarray(obs)))[:, 0].reshape(H, -1)
    steps = [_EpisodeEnv() for _ in range(1)][0]
    rew, done = [], []
    for _ in range(H):
        _, r, d = steps.step(None)
        rew.append(r)
        done.append(d)
    assert np.stack(done).any() and not np.stack(done).all()
    adv, ret = ppo.gae(np.stack(rew), val, np.stack(done), jt.gamma, jt.lam)
    assert np.abs(adv.reshape(-1) - adv_j).max() <= 1e-12
    assert np.abs(ret.reshape(-1) - ret_j).max() <= 1e-12


def test_checkpoints_interchange(tmp_path):
    obs = np.random.default_rng(4).normal(size=(3, 5)).astype(np.float32)
    pairs = [
        (jppo.PPOTrainer(_Stub(), hidden=8, seed=1),
         ppo.PPOTrainer(_Stub(), hidden=8, seed=2, device="cpu",
                        dtype=torch.float64)),
        (jsac.SACTrainer(_Stub(), hidden=8, seed=1),
         sac.SACTrainer(_Stub(), hidden=8, seed=2, device="cpu",
                        dtype=torch.float64)),
        (jrppo.RecurrentPPOTrainer(_Stub(), hidden=8, seed=1),
         recurrent_ppo.RecurrentPPOTrainer(_Stub(), hidden=8, seed=2,
                                           device="cpu",
                                           dtype=torch.float64)),
    ]

    def act(tr):
        a = tr.act(obs)
        return np.asarray(a[0] if isinstance(a, tuple) else a)

    for i, (jt, pt) in enumerate(pairs):
        path = str(tmp_path / f"jax{i}.pkl")
        jt.save(path)
        pt.load(path)
        assert np.abs(act(pt) - act(jt)).max() <= 1e-15
        # and back: the port's checkpoint of a changed policy into JAX
        with torch.no_grad():
            for p in pt.__dict__.get("pi", getattr(pt, "actor", None)
                                     ).parameters():
                p.mul_(1.5)
        path = str(tmp_path / f"port{i}.pkl")
        pt.save(path)
        with open(path, "rb") as f:
            assert pickle.load(f)[0] is not None
        jt.load(path)
        assert np.abs(act(pt) - act(jt)).max() <= 1e-15


# ---------------------------------------------------------------- learning


class _BanditEnv:
    """tests/test_training.py's stateless 6-action bandit: the reward is the
    (unscaled) first action component."""

    def __init__(self, n=4, obs_dim=3, action_scale=1e-3):
        self.n = n
        self.obs_dim = obs_dim
        self.scale = action_scale
        self.scene = types.SimpleNamespace(n_part=1)

    def reset(self):
        return np.zeros((self.n, self.obs_dim), np.float32)

    def step(self, act):
        rew = np.asarray(act)[:, 0] / self.scale
        return (np.zeros((self.n, self.obs_dim), np.float32),
                rew.astype(np.float32), np.ones((self.n,), bool))


def test_sac_learns_bandit():
    env = _BanditEnv(n=4)
    tr = sac.SACTrainer(env, total_steps=1200, start_steps=200,
                        batch_size=64, buffer_size=4096, hidden=32, seed=0,
                        device="cpu", dtype=torch.float64)
    tr.train(verbose=False)
    a = tr.act(env.reset()) / tr.action_scale
    assert float(np.mean(a[:, 0])) > 0.3, a[:, 0]


def test_recurrent_ppo_learns_bandit():
    env = _BanditEnv(n=8)
    tr = recurrent_ppo.RecurrentPPOTrainer(env, total_steps=4096, horizon=16,
                                           hidden=32, lr=3e-3, seed=0,
                                           device="cpu", dtype=torch.float64)
    tr.train(verbose=False)
    a, _ = tr.act(env.reset())
    assert float(np.mean(a[:, 0] / tr.action_scale)) > 0.3, a[:, 0]


# ------------------------------------------------------------------- CLI


def _install_sb3_stub(monkeypatch, record):
    """Stub stable_baselines3 / sb3_contrib modules implementing the API
    surface _sb3_train and make_sb3_vec_env use (SB3's DummyVecEnv
    conventions: batched reset/step, auto-reset on done)."""

    class _DummyVecEnv:
        def __init__(self, fns):
            self.envs = [f() for f in fns]
            self.num_envs = len(self.envs)
            self.action_space = self.envs[0].action_space
            self.observation_space = self.envs[0].observation_space

        def reset(self):
            return np.stack([e.reset()[0] for e in self.envs])

        def step(self, actions):
            obs, rews, dones = [], [], []
            for e, a in zip(self.envs, actions):
                o, r, term, trunc, _info = e.step(a)
                d = bool(term or trunc)
                if d:
                    o = e.reset()[0]
                obs.append(o)
                rews.append(r)
                dones.append(d)
            return (np.stack(obs), np.asarray(rews), np.asarray(dones),
                    [{}] * self.num_envs)

    def make_vec_env(fn, n_envs):
        record["n_envs"] = n_envs
        return _DummyVecEnv([fn] * n_envs)

    class EvalCallback:
        def __init__(self, eval_env, best_model_save_path=None, eval_freq=1,
                     deterministic=True):
            self.eval_env = eval_env
            self.path = best_model_save_path
            record["eval_freq"] = eval_freq

        def run(self, model):
            obs, _ = self.eval_env.reset()
            total = 0.0
            for _ in range(2):
                a = self.eval_env.action_space.sample()
                obs, r, term, trunc, _ = self.eval_env.step(a)
                assert obs.shape == self.eval_env.observation_space.shape
                total += float(r)
                if term or trunc:
                    break
            record["eval_return"] = total
            if self.path:
                model.save(os.path.join(self.path, "best_model"))

    class _Algo:
        def __init__(self, policy, venv, verbose=0):
            record["policy"] = policy
            self.venv = venv

        def learn(self, total_timesteps, callback=None):
            obs = self.venv.reset()
            assert obs.shape == (
                (self.venv.num_envs,) + self.venv.observation_space.shape)
            assert obs.dtype == np.float32
            for _ in range(int(total_timesteps)):
                acts = np.stack([self.venv.action_space.sample()
                                 for _ in range(self.venv.num_envs)])
                obs, rews, dones, _ = self.venv.step(acts)
                assert np.all(np.isfinite(rews))
                assert np.all(np.isfinite(obs))
            if callback is not None:
                callback.run(self)
            record["learned"] = int(total_timesteps)

        def save(self, path):
            with open(str(path) + ".stub", "wb") as f:
                f.write(b"sb3-stub")
            record.setdefault("saved", []).append(str(path))

    class PPO(_Algo):
        pass

    class SAC(_Algo):
        pass

    class RecurrentPPO(_Algo):
        pass

    sb3 = types.ModuleType("stable_baselines3")
    common = types.ModuleType("stable_baselines3.common")
    callbacks = types.ModuleType("stable_baselines3.common.callbacks")
    env_util = types.ModuleType("stable_baselines3.common.env_util")
    contrib = types.ModuleType("sb3_contrib")
    sb3.PPO, sb3.SAC, sb3.common = PPO, SAC, common
    callbacks.EvalCallback = EvalCallback
    env_util.make_vec_env = make_vec_env
    common.callbacks, common.env_util = callbacks, env_util
    contrib.RecurrentPPO = RecurrentPPO
    for name, mod in {
        "stable_baselines3": sb3,
        "stable_baselines3.common": common,
        "stable_baselines3.common.callbacks": callbacks,
        "stable_baselines3.common.env_util": env_util,
        "sb3_contrib": contrib,
    }.items():
        monkeypatch.setitem(sys.modules, name, mod)


def _args(tmp_path, **over):
    ns = types.SimpleNamespace(env="folding", tot_step=3, reward_name=None,
                               n_envs=2, timesteps=3, save_dir=str(tmp_path))
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


@pytest.mark.parametrize("algo", ["ppo", "recurrent_ppo"])
def test_sb3_train_contract(monkeypatch, tmp_path, algo):
    """_sb3_train drives the stubbed SB3 through real simulator envs:
    vectorized rollout, eval callback with best-model save, final save."""
    record = {}
    _install_sb3_stub(monkeypatch, record)
    scene = folding.make(table_n=4, max_newton_iter=3)
    cli._sb3_train(_args(tmp_path), scene, algo, str(tmp_path), "cpu")
    assert record["n_envs"] == 2
    assert record["learned"] == 3
    assert record["policy"] == (
        "MlpLstmPolicy" if algo == "recurrent_ppo" else "MlpPolicy")
    assert np.isfinite(record["eval_return"])
    assert os.path.exists(os.path.join(str(tmp_path), "best_model.stub"))
    assert os.path.exists(os.path.join(str(tmp_path), "final_model.stub"))


def test_cmd_rl_routes_to_sb3_when_available(monkeypatch, tmp_path):
    record, calls = {}, {}
    _install_sb3_stub(monkeypatch, record)
    scene = folding.make(table_n=4, max_newton_iter=3)
    monkeypatch.setattr(cli, "_make_scene", lambda a, device: scene)
    monkeypatch.setattr(
        cli, "_sb3_train", lambda args, sc, algo, sd, device: calls.update(
            algo=algo, save_dir=sd, device=device))
    cli.cmd_rl(_args(tmp_path, algo="sac", platform="cpu"))
    assert calls == {"algo": "sac", "save_dir": str(tmp_path),
                     "device": torch.device("cpu")}


@pytest.mark.parametrize("algo", ["ppo", "sac", "recurrent_ppo"])
def test_cli_rl_cpu(tmp_path, capsys, monkeypatch, algo):
    cli.main(["rl", "--platform", "cpu", "--env", "folding", "--algo", algo,
              "--n_envs", "2", "--horizon", "2", "--timesteps", "4",
              "--tot_step", "2", "--max_newton_iter", "2", "--save_dir",
              str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == f"saved models to {tmp_path}"
    files = sorted(os.listdir(tmp_path))
    if algo == "sac":  # 4 steps: random actions, no update, no evaluation
        assert files == ["final_model.pkl"]
    else:
        assert files == ["best_model.pkl", "final_model.pkl"]
        evals = [ln for ln in lines if ln.startswith("eval @ 4: return ")]
        assert len(evals) == 1 and np.isfinite(float(evals[0].split()[4]))
    with open(tmp_path / "final_model.pkl", "rb") as f:
        arrays = pickle.load(f)
    leaves = jax.tree.leaves(arrays)
    assert leaves and all(np.all(np.isfinite(x)) for x in leaves)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["rl", "--env", "folding", "--algo", algo])


def write_golden():
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from thinshelllab_tpu.scenes import base as jbase
    from thinshelllab_tpu.scenes import registry as jregistry
    from thinshelllab_tpu.train import rl_env as jrl

    out = {}
    env = jrl.Env("folding", time_step=LIMIT, **SCENE_CFG)
    out["env.obs0"] = env.reset()[0]
    out["env.obs64_0"] = np.asarray(jbase.observation(env.spec, env.state))
    rows = []
    for a in env_actions():
        obs, rew, done, _, _ = env.step(a.astype(np.float32))
        rows.append((obs, np.asarray(jbase.observation(env.spec, env.state)),
                     rew, done))
    for i, k in enumerate(("obs", "obs64", "rew", "done")):
        out["env." + k] = np.asarray([r[i] for r in rows])

    env = jrl.EvalEnv("folding", time_step=LIMIT, **SCENE_CFG)
    env.reset()
    rows = []
    for a in eval_actions():
        obs, delta, _, _, _ = env.step(a)
        rows.append((obs, np.asarray(jbase.observation(env.spec, env.state)),
                     delta))
    for i, k in enumerate(("obs", "obs64", "delta")):
        out["eval." + k] = np.asarray([r[i] for r in rows])

    sc = jregistry.make_scene("folding", **SCENE_CFG)
    env = jrl.BatchedEnv(sc, 2, time_limit=LIMIT)
    env.reset()
    env.t = jnp.asarray(BATCHED_T0, jnp.int32)
    obs_fn = jax.vmap(lambda s: jbase.observation(sc.spec, s))
    rows = []
    for a in batched_actions():
        obs, rew, done = env.step(a)
        rows.append((obs, np.asarray(obs_fn(env.states)), rew, done,
                     np.asarray(env.t)))
    # env 0's largest effector force component after each step (its stop
    # is decided against 10 N)
    from thinshelllab_tpu.engine import stepper

    st = jax.tree.map(jnp.asarray, sc.state0)
    params = jax.tree.map(jnp.asarray, sc.params)
    for a in batched_actions()[:2, 0]:
        st, _ = stepper.time_step(sc.spec, params, st, (
            jnp.asarray(a[None, :3]), jnp.asarray(a[None, 3:]),
            jnp.zeros((1,))))
        print("env 0 force", np.abs(np.asarray(
            jbase.effector_total_forces(sc.spec, params, st))).max())
    for i, k in enumerate(("obs", "obs64", "rew", "done", "t")):
        out["batched." + k] = np.asarray([r[i] for r in rows])
    np.savez(GOLDEN, **out)
    print({k: v for k, v in out.items() if "obs" not in k})


if __name__ == "__main__":
    write_golden()
