"""Rollout storage for on-policy training (counterpart of ``m3l_tpu/rl/buffer.py``).

Preallocated host numpy arrays filled during collection (the env pool is on the host), copied
to the device once per iteration for the update phase. Images stay uint8 on the device (4x
fewer bytes than f32); ``vt_load`` dequantizes them there.
"""
from __future__ import annotations

import numpy as np
import torch


class RolloutBuffer:
    def __init__(self, n_steps: int, n_envs: int, obs_space, action_dim: int):
        self.n_steps, self.n_envs = n_steps, n_envs
        self.obs = {k: np.zeros((n_steps, n_envs, *sp.shape), sp.dtype) for k, sp in obs_space.spaces.items()}
        self.actions = np.zeros((n_steps, n_envs, action_dim), np.float32)
        self.rewards = np.zeros((n_steps, n_envs), np.float32)
        self.episode_starts = np.zeros((n_steps, n_envs), np.float32)
        self.values = np.zeros((n_steps, n_envs), np.float32)
        self.log_probs = np.zeros((n_steps, n_envs), np.float32)
        self.pos = 0

    def add(self, obs: dict, actions, rewards, episode_starts, values, log_probs) -> None:
        t = self.pos
        for k in self.obs:
            self.obs[k][t] = obs[k]
        self.actions[t] = actions
        self.rewards[t] = rewards
        self.episode_starts[t] = episode_starts
        self.values[t] = values
        self.log_probs[t] = log_probs
        self.pos += 1

    def reset(self) -> None:
        self.pos = 0

    @property
    def full(self) -> bool:
        return self.pos == self.n_steps

    def to_device(self, device: torch.device) -> dict:
        """Flatten (T, E) -> N and copy to ``device``, one copy per array, dtypes unchanged."""
        n = self.n_steps * self.n_envs

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a.reshape(n, *a.shape[2:])).to(device)

        return {
            "obs": {k: put(v) for k, v in self.obs.items()},
            "actions": put(self.actions),
            "values": put(self.values),
            "log_probs": put(self.log_probs),
        }
