"""Reward normalization with running-return statistics (host numpy; the port's own copy of
``m3l_tpu/rl/vecnorm.py``).

SB3 ``VecNormalize(norm_obs=False, norm_reward=True)`` semantics: a discounted return
accumulator per env, a running mean/var over returns, rewards divided by the return std and
clipped, accumulators reset on done.
"""
from __future__ import annotations

import numpy as np


class RunningMeanStd:
    def __init__(self, shape=(), epsilon: float = 1e-4):
        self.mean = np.zeros(shape, np.float64)
        self.var = np.ones(shape, np.float64)
        self.count = epsilon

    def update(self, x: np.ndarray) -> None:
        batch_mean = np.mean(x, axis=0)
        batch_var = np.var(x, axis=0)
        batch_count = x.shape[0]
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + delta**2 * self.count * batch_count / tot
        self.mean, self.var, self.count = new_mean, m2 / tot, tot

    def state_dict(self) -> dict:
        return {"mean": self.mean.copy(), "var": self.var.copy(), "count": self.count}

    def load_state_dict(self, d: dict) -> None:
        self.mean, self.var, self.count = np.asarray(d["mean"]), np.asarray(d["var"]), float(d["count"])


class RewardNormalizer:
    def __init__(self, num_envs: int, gamma: float = 0.99, clip_reward: float = 10.0, epsilon: float = 1e-8, enabled: bool = True):
        self.gamma = gamma
        self.clip_reward = clip_reward
        self.epsilon = epsilon
        self.enabled = enabled
        self.returns = np.zeros(num_envs, np.float64)
        self.ret_rms = RunningMeanStd()

    def __call__(self, rewards: np.ndarray, dones: np.ndarray) -> np.ndarray:
        if not self.enabled:
            return rewards
        self.returns = self.returns * self.gamma + rewards
        self.ret_rms.update(self.returns)
        out = np.clip(rewards / np.sqrt(self.ret_rms.var + self.epsilon), -self.clip_reward, self.clip_reward)
        self.returns[dones.astype(bool)] = 0.0
        return out.astype(np.float32)

    def state_dict(self) -> dict:
        return {"returns": self.returns.copy(), "ret_rms": self.ret_rms.state_dict(), "enabled": self.enabled}

    def load_state_dict(self, d: dict) -> None:
        self.returns = np.asarray(d["returns"])
        self.ret_rms.load_state_dict(d["ret_rms"])
        self.enabled = bool(d.get("enabled", True))
