"""Observation wrappers (host numpy; the port's own copies of ``m3l_tpu/envs/wrappers.py``'s,
without gymnasium).

* :class:`FrameStack`: a rolling stack of the last N dict observations along a new leading axis
  per key; a reset fills the stack with the initial observation.
* :class:`ResizeDict`: one pixel key resized to (size, size) (cv2 ``INTER_AREA``), uint8 by
  default or f32 in [0, 1].
* :func:`read_touch_sensors`, :func:`assemble_hand_tactile`, :func:`symlog`: every MuJoCo touch
  sensor of an env, laid out as a hand-shaped (3, 32, 32) map (five fingers of three pads, then
  the palm), symlog-scaled. :class:`AddTactile` adds that map as the ``tactile`` key.
* :class:`RenderImageObservation`: the observation replaced by the env's off-screen frame
  (``image``) and, optionally, its touch map (``tactile``).

``cv2`` and ``mujoco`` are imported where they are used.
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

    def render(self):
        return self.env.render()

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def close(self) -> None:
        self.env.close()


class _ObservationWrapper:
    """A wrapper that maps each observation of ``env`` with :meth:`observation`."""

    def __init__(self, env):
        self.env = env
        self.action_space = env.action_space

    def observation(self, obs):
        raise NotImplementedError

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        return self.observation(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.observation(obs), reward, terminated, truncated, info

    def render(self):
        return self.env.render()

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def close(self) -> None:
        self.env.close()


class ResizeDict(_ObservationWrapper):
    """Resize ``pixel_key`` to (size, size), uint8 (the default: the images stay uint8 to the
    device) or, with ``to_float``, f32 in [0, 1]."""

    def __init__(self, env, size: int, pixel_key: str = "image", to_float: bool = False):
        super().__init__(env)
        self.size, self.pixel_key, self.to_float = size, pixel_key, to_float
        spaces = dict(env.observation_space.spaces)
        if to_float:
            spaces[pixel_key] = Box(low=0.0, high=1.0, shape=(size, size, 3), dtype=np.float32)
        else:
            spaces[pixel_key] = Box(low=0, high=255, shape=(size, size, 3), dtype=np.uint8)
        self.observation_space = Dict(spaces)

    def observation(self, obs):
        import cv2

        obs = dict(obs)
        img = obs[self.pixel_key]
        if img.shape[0] != self.size or img.shape[1] != self.size:
            img = cv2.resize(img, (self.size, self.size), interpolation=cv2.INTER_AREA)
        if self.to_float:
            img = img.astype(np.float32) / 255.0
        obs[self.pixel_key] = img
        return obs


def symlog(x: np.ndarray) -> np.ndarray:
    return np.sign(x) * np.log1p(np.abs(x))


def read_touch_sensors(env) -> np.ndarray:
    """Every MuJoCo touch sensor's reading of an (unwrapped) env, in sensor order; empty for an env
    without ``model`` and ``data``."""
    model = getattr(env, "model", None)
    data = getattr(env, "data", None)
    if model is None or data is None:
        return np.zeros(0, np.float32)
    import mujoco

    vals = [data.sensordata[model.sensor_adr[i]] for i in range(model.nsensor) if model.sensor_type[i] == mujoco.mjtSensor.mjSENS_TOUCH]
    return np.asarray(vals, np.float32)


def assemble_hand_tactile(vals: np.ndarray, size: int = 32) -> np.ndarray:
    """A hand-shaped (3, size, size) tactile map from raw touch readings, symlog-scaled: five
    fingers as 6-wide columns of three 4-row pads, each pad the mean of its share of the readings
    (len / 16 of them), the palm (rows 20 on, columns 8-24) the mean of the rest; channel 0 only."""
    tac = np.zeros((3, size, size), np.float32)
    if vals.size:
        per_pad = max(1, vals.size // 16)
        v = 0
        for finger in range(5):
            col = finger * 6 + 1
            for pad in range(3):
                row = pad * 4
                chunk = vals[v : v + per_pad]
                if chunk.size:
                    tac[0, row : row + 4, col : col + 4] = chunk.mean()
                v += per_pad
        palm = vals[v:]
        if palm.size:
            tac[0, 20:, 8:24] = palm.mean()
    return symlog(tac)


class AddTactile(_ObservationWrapper):
    """Add the (3, 32, 32) ``tactile`` map of the env's touch sensors to each observation."""

    N_CHANNELS = 3
    SIZE = 32

    def __init__(self, env):
        super().__init__(env)
        spaces = dict(env.observation_space.spaces)
        spaces["tactile"] = Box(low=-np.inf, high=np.inf, shape=(self.N_CHANNELS, self.SIZE, self.SIZE), dtype=np.float32)
        self.observation_space = Dict(spaces)

    def observation(self, obs):
        obs = dict(obs)
        obs["tactile"] = assemble_hand_tactile(read_touch_sensors(self.unwrapped), self.SIZE)
        return obs


class RenderImageObservation(_ObservationWrapper):
    """The observation replaced by the env's off-screen frame as ``image`` (uint8, resized to
    ``size`` where the frame is not), plus, ``with_tactile``, the ``tactile`` map of its touch
    sensors (zeros without any): pixel-only control, the state observation dropped."""

    def __init__(self, env, size: int = 64, tactile_size: int = 32, with_tactile: bool = True):
        super().__init__(env)
        self.size, self.tactile_size, self.with_tactile = size, tactile_size, with_tactile
        spaces = {"image": Box(low=0, high=255, shape=(size, size, 3), dtype=np.uint8)}
        if with_tactile:
            spaces["tactile"] = Box(low=-np.inf, high=np.inf, shape=(3, tactile_size, tactile_size), dtype=np.float32)
        self.observation_space = Dict(spaces)

    def observation(self, obs):
        frame = self.env.render()
        if frame.shape[0] != self.size:
            import cv2

            frame = cv2.resize(frame, (self.size, self.size), interpolation=cv2.INTER_AREA)
        out = {"image": np.asarray(frame, np.uint8)}
        if self.with_tactile:
            out["tactile"] = assemble_hand_tactile(read_touch_sensors(self.unwrapped), self.tactile_size)
        return out
