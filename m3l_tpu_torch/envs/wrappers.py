"""Observation wrappers (host numpy): ``FrameStack`` (the port's own copy of
``m3l_tpu/envs/wrappers.py`` ``FrameStack``, without gymnasium).

A rolling stack of the last N dict observations along a new leading axis per key; a reset
fills the stack with the initial observation.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .spaces import Box, Dict


class FrameStack:
    def __init__(self, env, num_stack: int):
        self.env = env
        self.num_stack = num_stack
        self.action_space = env.action_space
        keys = list(env.observation_space.spaces.keys())
        self.frames = {k: deque([], maxlen=num_stack) for k in keys}
        self.observation_space = Dict(
            {
                k: Box(
                    low=np.repeat(env.observation_space[k].low[None], num_stack, axis=0),
                    high=np.repeat(env.observation_space[k].high[None], num_stack, axis=0),
                    dtype=env.observation_space[k].dtype,
                )
                for k in keys
            }
        )

    def observation(self) -> dict:
        return {k: np.stack(self.frames[k], axis=0) for k in self.frames}

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        for k in self.frames:
            self.frames[k].append(obs[k])
        return self.observation(), reward, terminated, truncated, info

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        for k in self.frames:
            for _ in range(self.num_stack):
                self.frames[k].append(obs[k])
        return self.observation(), info

    def close(self) -> None:
        self.env.close()
