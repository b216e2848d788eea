"""Gymnasium environments over the simulator (counterpart of
`thinshelllab_tpu/train/rl_env.py`; reference training/RL_env.py).

Box action space of +-0.001 per (part x [dpos, drot]) dimension, the
subsampled observation vector (BaseScene.get_observation_kernel), reward
= exp(instantaneous task reward), termination on the time limit or the
early-stop test. Each environment holds its state on one device (default
the CUDA card; no card raises). `BatchedEnv` steps N environments one
after another on that device, each with its own episode time (the JAX
package vmaps them into one program).
"""
from __future__ import annotations

import numpy as np
import torch

try:
    import gymnasium
    from gymnasium import spaces

    _GYM = True
except ImportError:  # pragma: no cover
    gymnasium = None
    _GYM = False

from ..engine import stepper
from ..scenes import registry
from ..scenes.base import check_early_stop, observation, resolve_device


def _state_buffers(state):
    """A single state as a T=1 buffer dict for the buffer-based reward
    functions (instantaneous reward, as the reference RL env computes)."""
    g = state.gripper
    return {
        "pos": state.pos[None],
        "ref_angle": state.ref_angle[None],
        "gripper_pos": g.pos[None],
        "gripper_rot": g.rot[None],
        "gripper_dist": g.dist[None],
        "pad_local": g.pad_local[None],
    }


class _Stepper:
    """A scene on one device and its single-environment step."""

    def __init__(self, scene, reward_name, device, caller):
        self.device = resolve_device(device, caller)
        self.scene = scene
        self.n_part = scene.n_part
        self.spec, self.state0, self.params = scene.to(self.device)
        self.reward_fn = registry.resolve_reward(scene, reward_name)

    def step_state(self, state, dpos, drot, frame):
        """(new state, instantaneous reward, early stop): the reward and the
        stop as 0-dim tensors (the stop False without a gripper)."""
        spec = self.spec
        dis = torch.zeros((self.n_part,), dtype=spec.dtype,
                          device=self.device)
        new_state, _ = stepper.time_step(spec, self.params, state,
                                         (dpos, drot, dis))
        rew = self.reward_fn(_state_buffers(new_state))
        stop = (check_early_stop(spec, self.params, new_state, frame,
                                 rl=True) if self.n_part else False)
        return new_state, rew, stop


class Env(gymnasium.Env if _GYM else object):
    """One environment (reference RL_env.py). Built from a registry name
    with the reference env's kb=Kb and mu_cloth_elastic=mu, whatever the
    scene's own defaults (ROADMAP.md §3), or from a built `scene`."""

    metadata = {"render_modes": []}

    def __init__(self, sys_name="folding", time_step=100, reward_name=None,
                 Kb=100.0, mu=1.0, scene=None, device=None, **scene_kwargs):
        if scene is None:
            scene = registry.make_scene(sys_name, kb=Kb,
                                        mu_cloth_elastic=mu, **scene_kwargs)
        self._sim = _Stepper(scene, reward_name, device, "Env")
        self.scene = scene
        self.spec = self._sim.spec
        self.device = self._sim.device
        self.n_part = scene.n_part
        self.n_actions = 6 * max(self.n_part, 1)
        self.time_limit = time_step
        obs0 = observation(self.spec, self._sim.state0)
        self.n_observations = int(obs0.shape[0])
        if _GYM:
            self.action_space = spaces.Box(-0.001, 0.001,
                                           shape=(self.n_actions,),
                                           dtype=np.float32)
            self.observation_space = spaces.Box(-1000, 1000,
                                                shape=(self.n_observations,),
                                                dtype=np.float32)
        self.state = None
        self.t = 0

    def reset(self, seed=None, options=None):
        self.state = self._sim.state0
        self.t = 0
        obs = observation(self.spec, self.state).cpu().numpy()
        return obs.astype(np.float32), {}

    def step(self, action):
        a = np.asarray(action, np.float64).reshape(max(self.n_part, 1), 6)
        dpos = torch.as_tensor(a[: self.n_part, 0:3], dtype=self.spec.dtype,
                               device=self.device)
        drot = torch.as_tensor(a[: self.n_part, 3:6], dtype=self.spec.dtype,
                               device=self.device)
        self.t += 1
        self.state, rew, stop = self._sim.step_state(self.state, dpos, drot,
                                                     self.time_limit)
        obs = observation(self.spec, self.state).cpu().numpy()
        reward = float(np.exp(float(rew)))
        done = bool(stop) or self.t >= self.time_limit
        obs = obs.astype(np.float32)
        if done:
            obs = np.zeros_like(obs)
            reward = 0.0
        return obs, reward, done, done, {}

    def close(self):
        pass


class BatchedEnv:
    """N environments stepped one after another on one device.

    Per-env termination matches the reference env (RL_env.py step): time
    limit OR check_early_stop (NaN / force-diverged states). Done
    environments auto-reset to the initial state (the SB3 vec-env
    convention): the observation returned is the reset state's, the reward
    the step's. Each env keeps its own episode time `t[i]`.

    API: reset() -> (N, obs); step((N, n_actions)) -> (obs, rew, done)."""

    def __init__(self, scene, n_envs: int, time_limit=100, reward_name=None,
                 device=None):
        self._sim = _Stepper(scene, reward_name, device, "BatchedEnv")
        self.scene = scene
        self.spec = self._sim.spec
        self.device = self._sim.device
        self.n = n_envs
        self.time_limit = time_limit
        self.states = None
        self.t = None

    def reset(self):
        self.states = [self._sim.state0] * self.n
        self.t = np.zeros((self.n,), np.int64)
        obs = observation(self.spec, self._sim.state0).cpu().numpy()
        return np.repeat(obs[None].astype(np.float32), self.n, axis=0)

    def step(self, actions):
        n_part = self.scene.n_part
        acts = torch.as_tensor(np.asarray(actions), dtype=self.spec.dtype,
                               device=self.device).reshape(self.n, n_part, 6)
        obs, rews, dones = [], [], []
        for i in range(self.n):
            t = int(self.t[i])
            state, rew, stop = self._sim.step_state(
                self.states[i], acts[i, :, 0:3], acts[i, :, 3:6], t)
            done = bool(stop) or t + 1 >= self.time_limit
            if done:  # auto-reset: restart from state0 with t = 0
                state = self._sim.state0
            self.states[i] = state
            self.t[i] = 0 if done else t + 1
            obs.append(observation(self.spec, state))
            rews.append(rew)
            dones.append(done)
        obs = torch.stack(obs).cpu().numpy().astype(np.float32)
        rew = torch.stack(rews).cpu().numpy()
        return obs, np.exp(rew), np.asarray(dones)


def make_sb3_vec_env(sys_name, n_envs, **kwargs):
    """SB3-compatible vectorized env if stable_baselines3 is installed
    (parity with reference training_env.py); otherwise raises ImportError."""
    from stable_baselines3.common.env_util import make_vec_env

    return make_vec_env(lambda: Env(sys_name, **kwargs), n_envs=n_envs)


class EvalEnv(Env):
    """Evaluation wrapper returning the undiscounted per-step reward DELTA
    (reference training/RL_eval_env.py:20-43)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._last = 0.0

    def reset(self, seed=None, options=None):
        obs, info = super().reset(seed, options)
        self._last = 0.0
        return obs, info

    def step(self, action):
        obs, rew, done, trunc, info = super().step(action)
        # undo the exp() shaping and report the raw reward increment
        raw = float(np.log(max(rew, 1e-300))) if rew > 0 else self._last
        delta = raw - self._last
        self._last = raw
        return obs, delta, done, trunc, info
