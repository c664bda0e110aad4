"""Fake visuo-tactile insertion env for tests and benchmarks (the port's own copy of
``m3l_tpu/envs/fake.py`` ``FakeInsertionEnv``, on the port's spaces instead of gymnasium's).

Dict obs {image uint8 (64, 64, 3), tactile float32 (6, 32, 32) in symlog range} and a
continuous Box action, with deterministic, seedable dynamics: the agent nudges a latent point
towards a target, and the reward is a smooth function of their distance. The same seed and
actions give the same observations, rewards and flags as the JAX package's env.
"""
from __future__ import annotations

import numpy as np

from .spaces import Box, Dict


class FakeInsertionEnv:
    def __init__(
        self,
        image_size: int = 64,
        tactile_size: int = 32,
        num_sensors: int = 2,
        action_dim: int = 3,
        horizon: int = 300,
        state_type: str = "vision_and_touch",
        seed: int | None = None,
    ):
        self.image_size = image_size
        self.tactile_size = tactile_size
        self.num_sensors = num_sensors
        self.horizon = horizon
        self.state_type = state_type
        spaces = {}
        if state_type in ("vision", "vision_and_touch"):
            spaces["image"] = Box(low=0, high=255, shape=(image_size, image_size, 3), dtype=np.uint8)
        if state_type in ("touch", "vision_and_touch"):
            spaces["tactile"] = Box(low=-np.inf, high=np.inf, shape=(3 * num_sensors, tactile_size, tactile_size), dtype=np.float32)
        self.observation_space = Dict(spaces)
        self.action_space = Box(low=-1.0, high=1.0, shape=(action_dim,), dtype=np.float32)
        self._rng = np.random.default_rng(seed)
        self._target = np.zeros(action_dim, np.float32)
        self._pos = np.zeros(action_dim, np.float32)
        self._t = 0

    _GRID_CACHE: dict = {}

    @classmethod
    def _grid(cls, s: int):
        if s not in cls._GRID_CACHE:
            yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
            cls._GRID_CACHE[s] = (yy, xx)
        return cls._GRID_CACHE[s]

    @staticmethod
    def _blob(yy, xx, p, base_r: float = 0.02):
        """Gaussian blob at the camera projection of latent point ``p``: x/y through tanh to the
        frame, the third coordinate (if any) scaling its apparent size like depth."""
        cx = 0.5 + 0.4 * float(np.tanh(p[0]))
        cy = 0.5 + 0.4 * float(np.tanh(p[1 % len(p)]))
        r = base_r * (1.0 + 0.6 * float(np.tanh(p[2]))) if len(p) > 2 else base_r
        return np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / r))

    def _obs(self) -> dict:
        obs = {}
        s = self.image_size
        if "image" in self.observation_space.spaces:
            # the controlled "peg" (red/blue) and the episode's "socket" target (green)
            yy, xx = self._grid(s)
            blob = self._blob(yy, xx, self._pos)
            tgt = self._blob(yy, xx, self._target)
            img = np.stack([blob, np.maximum(0.5 * blob, tgt), 1.0 - blob], axis=-1)
            obs["image"] = (img * 255).astype(np.uint8)
        if "tactile" in self.observation_space.spaces:
            ts = self.tactile_size
            yy, xx = self._grid(ts)
            contact = float(np.exp(-np.sum((self._pos - self._target) ** 2)))
            maps = []
            for k in range(self.num_sensors):
                phase = 0.5 * k
                m = contact * np.exp(-(((xx - 0.5) ** 2 + (yy - 0.5 - 0.1 * np.sin(phase + self._t / 10)) ** 2) / 0.05))
                maps += [m, m * 0.5, m * 0.25]
            tac = np.stack(maps, axis=0).astype(np.float32)
            obs["tactile"] = np.sign(tac) * np.log1p(np.abs(tac * 5))
        return obs

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._target = self._rng.uniform(-0.5, 0.5, self.action_space.shape).astype(np.float32)
        self._pos = np.zeros(self.action_space.shape, np.float32)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        # the latent is clamped so the task stays observable (the blob saturates at tanh(+-1.5))
        self._pos = np.clip(self._pos + 0.1 * action, -1.5, 1.5)
        self._t += 1
        dist = float(np.linalg.norm(self._pos - self._target))
        reward = -dist + (1.0 if dist < 0.1 else 0.0)
        terminated = dist < 0.05
        truncated = self._t >= self.horizon
        return self._obs(), reward, terminated, truncated, {"is_success": terminated}

    def close(self) -> None:
        pass
