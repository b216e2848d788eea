"""Native PPO for BatchedEnv, used when stable-baselines3 is unavailable
(counterpart of `thinshelllab_tpu/train/ppo.py`; reference
training_env.py's SB3 PPO path).

A Gaussian MLP policy and a value MLP trained with clipped-surrogate PPO
and GAE, with torch.optim.Adam (eps 1e-8: lr * m_hat / (sqrt(v_hat) +
eps), optax.adam's update). The modules compute x @ W + b with W stored
transposed as nn.Linear stores it, so the JAX package's (in, out) weights
carry across by transposition (core/convert.ppo_from_reference), and
checkpoints keep the JAX package's pickle layout of numpy arrays.

Randomness: weights are drawn on the CPU from a torch.Generator seeded
with `seed` (so a trainer on the card starts from the CPU trainer's
weights), the policy noise from a generator on the trainer's device
through `draw_noise`, which a caller may replace, and the minibatch
shuffle from a seeded np.random.Generator.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch
from torch import nn

from ..scenes.base import resolve_device

_LOG_2PI = math.log(2 * math.pi)


class MLP(nn.Module):
    """tanh MLP; layer i computes x @ W_i + b_i (W_i stored as
    nn.Linear's (out, in) weight). Weights N(0, 2 / fan_in), biases 0."""

    def __init__(self, sizes, generator, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList()
        for i in range(len(sizes) - 1):
            lin = nn.Linear(sizes[i], sizes[i + 1], dtype=dtype)
            with torch.no_grad():
                w = torch.randn((sizes[i], sizes[i + 1]), generator=generator,
                                dtype=lin.weight.dtype)
                lin.weight.copy_((w * math.sqrt(2.0 / sizes[i])).T)
                lin.bias.zero_()
            self.layers.append(lin)

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = torch.tanh(x)
        return x

    def arrays(self):
        """The JAX package's layout: [(W (in, out), b), ...] numpy."""
        return [(lin.weight.detach().T.cpu().numpy(),
                 lin.bias.detach().cpu().numpy()) for lin in self.layers]

    def load_arrays(self, arrays):
        with torch.no_grad():
            for lin, (w, b) in zip(self.layers, arrays, strict=True):
                lin.weight.copy_(torch.as_tensor(np.asarray(w)).T)
                lin.bias.copy_(torch.as_tensor(np.asarray(b)))


def gaussian_logp(act, mean, log_std):
    return -0.5 * torch.sum(((act - mean) / torch.exp(log_std)) ** 2
                            + 2 * log_std + _LOG_2PI, dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))


def gae(rew, val, done, gamma, lam):
    """Generalized advantage estimates over an (H, N) rollout with
    episode-boundary masking (done envs bootstrap to 0; the last step
    bootstraps on its own value). Returns (normalized advantages,
    returns), numpy."""
    done_m = np.asarray(done).astype(rew.dtype)
    adv = np.zeros_like(rew)
    lastgaelam = 0.0
    for t in reversed(range(len(rew))):
        next_val = val[t + 1] if t + 1 < len(rew) else val[t]
        nonterm = 1.0 - done_m[t]
        delta = rew[t] + gamma * next_val * nonterm - val[t]
        lastgaelam = delta + gamma * lam * nonterm * lastgaelam
        adv[t] = lastgaelam
    ret = adv + val
    return (adv - adv.mean()) / (adv.std() + 1e-8), ret


def ppo_loss(logp, logp_old, adv, v, ret, log_std, clip):
    """Clipped surrogate + 0.5 value loss - 0.001 entropy."""
    ratio = torch.exp(logp - logp_old)
    clipped = torch.clamp(ratio, 1 - clip, 1 + clip)
    pg = -torch.mean(torch.minimum(ratio * adv, clipped * adv))
    vloss = torch.mean((v - ret) ** 2)
    return pg + 0.5 * vloss - 0.001 * gaussian_entropy(log_std)


class _Trainer:
    """Device, dtype, generators and the noise hook shared by the
    trainers."""

    def _setup(self, env, seed, device, dtype, caller):
        self.env = env
        self.device = resolve_device(device, caller)
        self.dtype = torch.get_default_dtype() if dtype is None else dtype
        self.init_gen = torch.Generator().manual_seed(seed)
        self.noise_gen = torch.Generator(self.device).manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)

    def draw_noise(self, shape):
        """Standard normal draws of the policy noise (a hook: tests replace
        it with the JAX package's draws)."""
        return torch.randn(shape, generator=self.noise_gen, dtype=self.dtype,
                           device=self.device)

    def _t(self, x):
        """x (a numpy array or a tensor on any device) as a tensor of the
        policy's dtype on its device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=self.dtype)
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    def _adam(self, params, lr):
        return torch.optim.Adam(params, lr=lr, eps=1e-8)


class PPOTrainer(_Trainer):
    def __init__(self, env, total_steps=100_000, horizon=64, lr=3e-4,
                 gamma=0.99, lam=0.95, clip=0.2, epochs=4, minibatches=4,
                 hidden=64, seed=0, action_scale=1e-3, device=None,
                 dtype=None):
        self._setup(env, seed, device, dtype, "PPOTrainer")
        self.total_steps = total_steps
        self.horizon = horizon
        self.gamma = gamma
        self.lam = lam
        self.clip = clip
        self.epochs = epochs
        self.minibatches = minibatches
        self.action_scale = action_scale
        obs_dim = env.reset().shape[1]
        act_dim = env.scene.n_part * 6
        self.act_dim = act_dim
        self.pi = MLP([obs_dim, hidden, hidden, act_dim], self.init_gen,
                      self.dtype).to(self.device)
        self.vf = MLP([obs_dim, hidden, hidden, 1], self.init_gen,
                      self.dtype).to(self.device)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.5,
                                               dtype=self.dtype,
                                               device=self.device))
        self.optimizer = self._adam([*self.pi.parameters(),
                                     *self.vf.parameters(), self.log_std],
                                    lr)

    # ---------------------------------------------------------------- core

    def policy(self, obs, noise):
        """(action, logp) of the Gaussian policy with the given standard
        normal noise."""
        mean = self.pi(obs)
        act = mean + noise * torch.exp(self.log_std)
        return act, gaussian_logp(act, mean, self.log_std)

    def update(self, batch):
        """One Adam step on the PPO loss of a minibatch (obs, act, adv,
        ret, logp_old)."""
        obs, act, adv, ret, logp_old = (self._t(b) for b in batch)
        logp = gaussian_logp(act, self.pi(obs), self.log_std)
        v = self.vf(obs)[:, 0]
        loss = ppo_loss(logp, logp_old, adv, v, ret, self.log_std, self.clip)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()

    # ------------------------------------------------------------- training

    def train(self, verbose=True, callback=None):
        """callback(steps_done) is invoked after every policy update (the
        EvalCallback hook of the reference SB3 trainer, training_env.py:86)."""
        env = self.env
        steps_done = 0
        obs = env.reset()
        while steps_done < self.total_steps:
            traj = {k: [] for k in ("obs", "act", "rew", "val", "logp", "done")}
            for _ in range(self.horizon):
                o = self._t(obs)
                with torch.no_grad():
                    act, logp = self.policy(
                        o, self.draw_noise((o.shape[0], self.act_dim)))
                    val = self.vf(o)[:, 0]
                scaled = (torch.clamp(act, -1, 1) * self.action_scale
                          ).cpu().numpy().astype(np.float64)
                obs2, rew, done = env.step(scaled)  # env auto-resets done envs
                for key_, v in (("obs", o), ("act", act), ("rew", rew),
                                ("val", val), ("logp", logp), ("done", done)):
                    traj[key_].append(v.cpu().numpy()
                                      if isinstance(v, torch.Tensor)
                                      else np.asarray(v))
                obs = obs2
                steps_done += env.n
            rew = np.stack(traj["rew"])  # (H, N)
            adv, ret = gae(rew, np.stack(traj["val"]), np.stack(traj["done"]),
                           self.gamma, self.lam)
            flat = {k: np.concatenate([a.reshape(env.n, -1)
                                       for a in traj[k]])
                    for k in ("obs", "act")}
            cols = (flat["obs"], flat["act"], adv.reshape(-1),
                    ret.reshape(-1), np.stack(traj["logp"]).reshape(-1))
            idx = np.arange(cols[0].shape[0])
            for _ in range(self.epochs):
                self.np_rng.shuffle(idx)
                for mb in np.array_split(idx, self.minibatches):
                    self.update(tuple(c[mb] for c in cols))
            if verbose:
                print(f"steps {steps_done}: mean step reward "
                      f"{float(np.mean(rew)):.4f}", flush=True)
            if callback is not None:
                callback(steps_done)

    def act(self, obs):
        with torch.no_grad():
            mean = self.pi(self._t(obs))
        return (torch.clamp(mean, -1, 1) * self.action_scale).cpu().numpy()

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump((self.pi.arrays(), self.vf.arrays(),
                         self.log_std.detach().cpu().numpy()), f)

    def load(self, path):
        with open(path, "rb") as f:
            pi, vf, log_std = pickle.load(f)
        self.pi.load_arrays(pi)
        self.vf.load_arrays(vf)
        with torch.no_grad():
            self.log_std.copy_(torch.as_tensor(np.asarray(log_std)))
