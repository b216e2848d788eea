"""Native SAC for BatchedEnv, used when stable-baselines3 is unavailable
(counterpart of `thinshelllab_tpu/train/sac.py`; reference
training/training_env.py:134-151, algo branch "SAC").

A tanh-squashed Gaussian actor, twin Q critics with polyak-averaged
targets, automatic entropy-temperature tuning (target entropy -act_dim)
and a numpy ring replay buffer, with torch.optim.Adam (eps 1e-8) for the
actor, the critics and the temperature. The update's two Gaussian draws
are arguments (`update(batch, noise_target, noise_actor)`); the training
loop draws them through `draw_noise`.
"""
from __future__ import annotations

import copy
import pickle

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .ppo import MLP, _Trainer, _LOG_2PI

_LOG_STD_MIN, _LOG_STD_MAX = -20.0, 2.0
_LOG_2 = float(np.log(2.0))


def squashed_gaussian(actor, obs, noise):
    """(tanh action, its log-prob with the tanh correction, tanh(mean))
    for the given standard normal noise; log-std clipped to [-20, 2]."""
    out = actor(obs)
    mean, log_std = torch.chunk(out, 2, dim=-1)
    log_std = torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)
    pre = mean + noise * torch.exp(log_std)
    act = torch.tanh(pre)
    logp = -0.5 * torch.sum(noise**2 + 2 * log_std + _LOG_2PI, dim=-1)
    logp = logp - torch.sum(2 * (_LOG_2 - pre - F.softplus(-2 * pre)),
                            dim=-1)
    return act, logp, torch.tanh(mean)


class ReplayBuffer:
    def __init__(self, capacity, obs_dim, act_dim):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.act = np.zeros((capacity, act_dim), np.float32)
        self.rew = np.zeros((capacity,), np.float32)
        self.obs2 = np.zeros((capacity, obs_dim), np.float32)
        self.done = np.zeros((capacity,), np.float32)
        self.ptr = 0
        self.size = 0

    def add_batch(self, obs, act, rew, obs2, done):
        n = obs.shape[0]
        idx = (self.ptr + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.act[idx] = act
        self.rew[idx] = rew
        self.obs2[idx] = obs2
        self.done[idx] = done
        self.ptr = int((self.ptr + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, rng, batch):
        idx = rng.integers(0, self.size, batch)
        return (self.obs[idx], self.act[idx], self.rew[idx], self.obs2[idx],
                self.done[idx])


def _q(q, obs, act):
    return q(torch.cat([obs, act], dim=-1))[:, 0]


def _set_grads(params, grads):
    for p, g in zip(params, grads, strict=True):
        p.grad = g


class SACTrainer(_Trainer):
    def __init__(self, env, total_steps=100_000, lr=3e-4, gamma=0.99,
                 tau=0.005, batch_size=256, buffer_size=200_000,
                 start_steps=500, updates_per_step=1, hidden=64, seed=0,
                 action_scale=1e-3, device=None, dtype=None):
        self._setup(env, seed, device, dtype, "SACTrainer")
        self.total_steps = total_steps
        self.gamma = gamma
        self.tau = tau
        self.batch_size = batch_size
        self.start_steps = start_steps
        self.updates_per_step = updates_per_step
        self.action_scale = action_scale
        obs_dim = env.reset().shape[1]
        act_dim = env.scene.n_part * 6
        self.act_dim = act_dim
        self.buffer = ReplayBuffer(buffer_size, obs_dim, act_dim)

        def mlp(sizes):
            return MLP(sizes, self.init_gen, self.dtype).to(self.device)

        self.actor = mlp([obs_dim, hidden, hidden, 2 * act_dim])
        self.q1 = mlp([obs_dim + act_dim, hidden, hidden, 1])
        self.q2 = mlp([obs_dim + act_dim, hidden, hidden, 1])
        self.q1_targ = copy.deepcopy(self.q1).requires_grad_(False)
        self.q2_targ = copy.deepcopy(self.q2).requires_grad_(False)
        self.log_alpha = nn.Parameter(torch.zeros((), dtype=self.dtype,
                                                  device=self.device))
        self.actor_opt = self._adam(self.actor.parameters(), lr)
        self.q_opt = self._adam([*self.q1.parameters(),
                                 *self.q2.parameters()], lr)
        self.alpha_opt = self._adam([self.log_alpha], lr)
        self.target_entropy = -float(act_dim)

    # ----------------------------------------------------------------- core

    def update(self, batch, noise_target, noise_actor):
        """One SAC update on a sampled batch (obs, act, rew, obs2, done):
        the critics on the soft Bellman backup (noise_target draws the
        next actions), the actor against the new critics and the
        temperature on the actor's log-probs (noise_actor draws both), then
        the polyak targets."""
        obs, act, rew, obs2, done = batch
        obs, act, obs2 = self._t(obs), self._t(act), self._t(obs2)
        # reward and done keep the buffer's float32, as in the JAX update:
        # there the discount gamma * (1 - done) is a float32 product too
        rew, done = (torch.as_tensor(np.asarray(b), device=self.device)
                     for b in (rew, done))
        alpha = torch.exp(self.log_alpha.detach())
        with torch.no_grad():
            a2, logp2, _ = squashed_gaussian(self.actor, obs2, noise_target)
            q_targ = torch.minimum(_q(self.q1_targ, obs2, a2),
                                   _q(self.q2_targ, obs2, a2))
            backup = rew + self.gamma * (1.0 - done) * (q_targ
                                                        - alpha * logp2)
        q_params = [*self.q1.parameters(), *self.q2.parameters()]
        q_loss = (torch.mean((_q(self.q1, obs, act) - backup) ** 2)
                  + torch.mean((_q(self.q2, obs, act) - backup) ** 2))
        _set_grads(q_params, torch.autograd.grad(q_loss, q_params))
        self.q_opt.step()

        a_params = list(self.actor.parameters())
        a, logp, _ = squashed_gaussian(self.actor, obs, noise_actor)
        q = torch.minimum(_q(self.q1, obs, a), _q(self.q2, obs, a))
        actor_loss = torch.mean(alpha * logp - q)
        _set_grads(a_params, torch.autograd.grad(actor_loss, a_params))
        self.actor_opt.step()

        alpha_loss = -torch.mean(torch.exp(self.log_alpha)
                                 * (logp.detach() + self.target_entropy))
        (self.log_alpha.grad,) = torch.autograd.grad(alpha_loss,
                                                     [self.log_alpha])
        self.alpha_opt.step()

        with torch.no_grad():
            for targ, src in ((self.q1_targ, self.q1),
                              (self.q2_targ, self.q2)):
                for t, s in zip(targ.parameters(), src.parameters()):
                    t.copy_((1 - self.tau) * t + self.tau * s)

    # ------------------------------------------------------------- training

    def train(self, verbose=True, callback=None):
        """callback(steps_done) fires after each environment batch + updates
        (EvalCallback hook parity, reference training_env.py:86)."""
        env = self.env
        obs = env.reset()
        steps_done = 0
        while steps_done < self.total_steps:
            if steps_done < self.start_steps:
                act = self.np_rng.uniform(-1, 1, (env.n, self.act_dim))
            else:
                with torch.no_grad():
                    a, _, _ = squashed_gaussian(
                        self.actor, self._t(obs),
                        self.draw_noise((env.n, self.act_dim)))
                act = a.cpu().numpy()
            obs2, rew, done = env.step(act * self.action_scale)
            # rew is already exp-shaped by the env (reference RL_env.py:205)
            self.buffer.add_batch(obs, act.astype(np.float32),
                                  rew.astype(np.float32), obs2,
                                  done.astype(np.float32))
            obs = obs2
            steps_done += env.n
            if self.buffer.size >= self.batch_size:
                for _ in range(self.updates_per_step):
                    batch = self.buffer.sample(self.np_rng, self.batch_size)
                    shape = (self.batch_size, self.act_dim)
                    self.update(batch, self.draw_noise(shape),
                                self.draw_noise(shape))
            if verbose and steps_done % (env.n * 16) == 0:
                print(f"steps {steps_done}: mean step reward "
                      f"{float(np.mean(rew)):.4f} alpha "
                      f"{float(torch.exp(self.log_alpha)):.3f}", flush=True)
            if callback is not None and steps_done % (env.n * 16) == 0:
                callback(steps_done)

    def act(self, obs):
        with torch.no_grad():
            mean, _ = torch.chunk(self.actor(self._t(obs)), 2, dim=-1)
        return torch.tanh(mean).cpu().numpy() * self.action_scale

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump((self.actor.arrays(), self.q1.arrays(),
                         self.q2.arrays(),
                         self.log_alpha.detach().cpu().numpy()), f)

    def load(self, path):
        """Loads the actor, the critics and the temperature, as the JAX
        trainer does (the targets and the optimizers' moments stay)."""
        with open(path, "rb") as f:
            actor, q1, q2, log_alpha = pickle.load(f)
        self.actor.load_arrays(actor)
        self.q1.load_arrays(q1)
        self.q2.load_arrays(q2)
        with torch.no_grad():
            self.log_alpha.copy_(torch.as_tensor(np.asarray(log_alpha)))
