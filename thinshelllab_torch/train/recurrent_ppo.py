"""Native RecurrentPPO (LSTM policy) for BatchedEnv (counterpart of
`thinshelllab_tpu/train/recurrent_ppo.py`; reference
training/training_env.py:134-151, sb3_contrib branch).

A shared LSTM torso with Gaussian policy and value heads, PPO
clipped-surrogate updates with full-sequence BPTT over each rollout chunk,
the hidden state carried across steps and reset per env on episode end.
The LSTM cell is the JAX package's, not nn.LSTM's: one bias, gate order
i, f, g, o, and +1 on the forget gate inside its sigmoid (ROADMAP.md §3).
"""
from __future__ import annotations

import math
import pickle
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .ppo import MLP, _Trainer, gae, gaussian_logp, ppo_loss


class LSTMParams(NamedTuple):
    """The JAX package's LSTM arrays: wi (in, 4H), wh (H, 4H), b (4H,)."""

    wi: np.ndarray
    wh: np.ndarray
    b: np.ndarray


class LSTMCell(nn.Module):
    """gates = x @ Wi + h @ Wh + b (Wi, Wh stored transposed, (4H, in) and
    (4H, H)); c' = sigmoid(f + 1) c + sigmoid(i) tanh(g), h' = sigmoid(o)
    tanh(c'). Weights U(-1/sqrt(H), 1/sqrt(H)), bias 0."""

    def __init__(self, in_dim, hidden, generator, dtype=None):
        super().__init__()
        s = 1.0 / math.sqrt(hidden)
        dtype = torch.get_default_dtype() if dtype is None else dtype

        def uniform(shape):
            u = torch.rand(shape, generator=generator, dtype=dtype)
            return nn.Parameter((u * 2 * s - s).T.contiguous())

        self.wi = uniform((in_dim, 4 * hidden))
        self.wh = uniform((hidden, 4 * hidden))
        self.b = nn.Parameter(torch.zeros((4 * hidden,), dtype=dtype))

    def forward(self, carry, x):
        h, c = carry
        gates = x @ self.wi.T + h @ self.wh.T + self.b
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    def arrays(self):
        return LSTMParams(*(p.detach().cpu().numpy()
                            for p in (self.wi.T, self.wh.T, self.b)))

    def load_arrays(self, arrays):
        wi, wh, b = (torch.as_tensor(np.asarray(a)) for a in arrays)
        with torch.no_grad():
            self.wi.copy_(wi.T)
            self.wh.copy_(wh.T)
            self.b.copy_(b)


class _Unpickler(pickle.Unpickler):
    """Reads the JAX package's checkpoints, whose LSTM arrays are pickled
    as its own LSTMParams, into this module's LSTMParams."""

    def find_class(self, module, name):
        if name == "LSTMParams" and module.endswith("train.recurrent_ppo"):
            return LSTMParams
        return super().find_class(module, name)


class RecurrentPPOTrainer(_Trainer):
    def __init__(self, env, total_steps=100_000, horizon=64, lr=3e-4,
                 gamma=0.99, lam=0.95, clip=0.2, epochs=4, hidden=64,
                 seed=0, action_scale=1e-3, device=None, dtype=None):
        self._setup(env, seed, device, dtype, "RecurrentPPOTrainer")
        self.total_steps = total_steps
        self.horizon = horizon
        self.gamma = gamma
        self.lam = lam
        self.clip = clip
        self.epochs = epochs
        self.hidden = hidden
        self.action_scale = action_scale
        obs_dim = env.reset().shape[1]
        act_dim = env.scene.n_part * 6
        self.act_dim = act_dim
        self.lstm = LSTMCell(obs_dim, hidden, self.init_gen,
                             self.dtype).to(self.device)
        self.pi = MLP([hidden, hidden, act_dim], self.init_gen,
                      self.dtype).to(self.device)
        self.vf = MLP([hidden, 1], self.init_gen, self.dtype).to(self.device)
        self.log_std = nn.Parameter(torch.full((act_dim,), -0.5,
                                               dtype=self.dtype,
                                               device=self.device))
        self.optimizer = self._adam(
            [*self.lstm.parameters(), *self.pi.parameters(),
             *self.vf.parameters(), self.log_std], lr)

    # ----------------------------------------------------------------- core

    def zero_carry(self, n):
        z = torch.zeros((n, self.hidden), dtype=self.dtype,
                        device=self.device)
        return (z, z.clone())

    def fwd_step(self, obs, carry, noise):
        """One policy step: (carry, action, logp, value) with the given
        standard normal noise."""
        carry, h = self.lstm(carry, obs)
        mean = self.pi(h)
        val = self.vf(h)[:, 0]
        act = mean + noise * torch.exp(self.log_std)
        return carry, act, gaussian_logp(act, mean, self.log_std), val

    def sequence_logp_v(self, obs_seq, act_seq, done_seq, carry0):
        """Re-run the LSTM over the (H, N, obs) rollout; the carry is zeroed
        after done steps (matching collection). Returns (logp, v), (H, N)."""
        carry = carry0
        logps, vs = [], []
        for obs, act, done_prev in zip(obs_seq, act_seq, done_seq):
            keep = (1.0 - done_prev)[:, None]
            carry = tuple(c * keep for c in carry)
            carry, h = self.lstm(carry, obs)
            logps.append(gaussian_logp(act, self.pi(h), self.log_std))
            vs.append(self.vf(h)[:, 0])
        return torch.stack(logps), torch.stack(vs)

    def update(self, batch):
        """One Adam step on the PPO loss of a whole rollout chunk (obs, act,
        adv, ret, logp_old, done_prev, carry0), BPTT through the LSTM."""
        obs, act, adv, ret, logp_old, done_prev, carry0 = batch
        obs, act, adv, ret, logp_old = (self._t(b) for b in
                                        (obs, act, adv, ret, logp_old))
        done_prev = torch.as_tensor(np.asarray(done_prev),
                                    device=self.device)
        carry0 = tuple(self._t(c) for c in carry0)
        logp, v = self.sequence_logp_v(obs, act, done_prev, carry0)
        loss = ppo_loss(logp, logp_old, adv, v, ret, self.log_std, self.clip)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()

    # ------------------------------------------------------------- training

    def train(self, verbose=True, callback=None):
        """callback(steps_done) fires after every policy update (EvalCallback
        hook parity, reference training_env.py:86)."""
        env = self.env
        obs = env.reset()
        n = env.n
        carry = self.zero_carry(n)
        done_prev = np.zeros((n,), np.float32)
        steps_done = 0
        while steps_done < self.total_steps:
            traj = {k: [] for k in
                    ("obs", "act", "rew", "val", "logp", "done", "done_prev")}
            carry0 = tuple(c.clone() for c in carry)
            for _ in range(self.horizon):
                keep = self._t(1.0 - done_prev)[:, None]
                o = self._t(obs)
                with torch.no_grad():
                    carry = tuple(c * keep for c in carry)
                    carry, act, logp, val = self.fwd_step(
                        o, carry, self.draw_noise((n, self.act_dim)))
                scaled = (torch.clamp(act, -1, 1) * self.action_scale
                          ).cpu().numpy().astype(np.float64)
                obs2, rew, done = env.step(scaled)
                for key_, v in (("obs", o), ("act", act), ("rew", rew),
                                ("val", val), ("logp", logp), ("done", done),
                                ("done_prev", done_prev)):
                    traj[key_].append(v.cpu().numpy()
                                      if isinstance(v, torch.Tensor)
                                      else np.asarray(v))
                obs = obs2
                done_prev = done.astype(np.float32)
                steps_done += n
            rew = np.stack(traj["rew"])
            adv, ret = gae(rew, np.stack(traj["val"]), np.stack(traj["done"]),
                           self.gamma, self.lam)
            batch = (np.stack(traj["obs"]), np.stack(traj["act"]), adv, ret,
                     np.stack(traj["logp"]),
                     np.stack(traj["done_prev"]).astype(np.float32), carry0)
            for _ in range(self.epochs):
                self.update(batch)
            if verbose:
                print(f"steps {steps_done}: mean step reward "
                      f"{float(np.mean(rew)):.4f}", flush=True)
            if callback is not None:
                callback(steps_done)

    def act(self, obs, carry=None):
        """Deterministic action and the next carry (zeros when None)."""
        o = self._t(obs)
        if carry is None:
            carry = self.zero_carry(o.shape[0])
        with torch.no_grad():
            carry, h = self.lstm(carry, o)
            mean = self.pi(h)
        return (torch.clamp(mean, -1, 1).cpu().numpy() * self.action_scale,
                carry)

    def save(self, path):
        """The JAX package's layout: (lstm (wi, wh, b), pi, vf, log_std),
        the LSTM arrays a plain tuple."""
        with open(path, "wb") as f:
            pickle.dump((tuple(self.lstm.arrays()), self.pi.arrays(),
                         self.vf.arrays(),
                         self.log_std.detach().cpu().numpy()), f)

    def load(self, path):
        with open(path, "rb") as f:
            lstm, pi, vf, log_std = _Unpickler(f).load()
        self.lstm.load_arrays(lstm)
        self.pi.load_arrays(pi)
        self.vf.load_arrays(vf)
        with torch.no_grad():
            self.log_std.copy_(torch.as_tensor(np.asarray(log_std)))
