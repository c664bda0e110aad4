"""In-process vectorized env pool (host numpy; the port's own copy of ``m3l_tpu/envs/vec.py``
``SyncVecEnv``).

SB3 VecEnv step semantics: auto-reset on done, ``terminal_observation`` and
``TimeLimit.truncated`` in the infos, and Monitor-style ``episode`` stats {r, l, s} over the
raw rewards. The process pools of the JAX package are a later slice.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def _stack_obs(obs_list: Sequence[dict]) -> dict:
    return {k: np.stack([o[k] for o in obs_list]) for k in obs_list[0]}


class _Monitor:
    """Episode return, length and success over raw rewards."""

    def __init__(self):
        self.ret = 0.0
        self.len = 0
        self.success = False

    def step(self, reward: float, info: dict | None = None) -> None:
        self.ret += float(reward)
        self.len += 1
        if info is not None and info.get("is_success", False):
            self.success = True

    def pop(self) -> dict:
        ep = {"r": self.ret, "l": self.len, "s": float(self.success)}
        self.ret, self.len, self.success = 0.0, 0, False
        return ep


class SyncVecEnv:
    def __init__(self, env_fns: Sequence[Callable]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = self.envs[0].observation_space
        self.action_space = self.envs[0].action_space
        self._monitors = [_Monitor() for _ in self.envs]

    def reset(self, seed: int | None = None) -> dict:
        obs = []
        for i, env in enumerate(self.envs):
            o, _ = env.reset(seed=None if seed is None else seed + i)
            obs.append(o)
        return _stack_obs(obs)

    def step(self, actions: np.ndarray):
        obs_list, rewards, dones, infos = [], [], [], []
        for i, env in enumerate(self.envs):
            o, r, term, trunc, info = env.step(actions[i])
            self._monitors[i].step(r, info)
            done = term or trunc
            info = dict(info)
            if done:
                info["terminal_observation"] = o
                info["TimeLimit.truncated"] = bool(trunc and not term)
                info["episode"] = self._monitors[i].pop()
                o, _ = env.reset()
            obs_list.append(o)
            rewards.append(r)
            dones.append(done)
            infos.append(info)
        return _stack_obs(obs_list), np.asarray(rewards, np.float32), np.asarray(dones, bool), infos

    def close(self) -> None:
        for env in self.envs:
            env.close()
