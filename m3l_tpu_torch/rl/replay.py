"""Replay buffers for off-policy training (counterpart of ``m3l_tpu/rl/replay.py``).

* :class:`ReplayBuffer`, the host numpy ring, a copy of the JAX package's: observations are
  stored once (next_obs is the ring's next slot, valid because the TD target masks next-state
  values on terminal steps), images stay uint8 and float32 maps are kept as float16. Truncated
  (timeout) episodes, whose real next observation is the terminal one rather than the
  auto-reset obs, keep their terminal obs in a sparse side table, so SB3's
  ``handle_timeout_termination`` bootstrap holds exactly.
* :class:`DeviceReplayBuffer`, the same ring in device memory: every minibatch is gathered on the
  device, and the only host-to-device traffic per transition is the new observation. Each obs
  key is a ``(capacity, n_envs, prod(shape))`` tensor (float32 and float16 maps stored as bf16),
  reshaped to the obs shape only after the gather; the fused gradient steps of
  ``SACMAE.train_steps`` index that flat layout directly. Writes are indexed assignments in
  place. Truncated transitions keep their terminal obs in a device side ring of
  ``timeout_capacity`` slots, referenced by slot index; the host warns when that ring wraps onto
  a slot whose transition is still sampleable.

Sample indices are drawn on the host with the JAX package's numpy ``Generator`` calls, so the
same seed and adds give the same transitions on both sides.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..utils.device import resolve_device

_STORE_DTYPES = {np.dtype(np.float32): np.float16}
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32}


def _ring_indices(full: bool, pos: int, capacity: int, n_envs: int, batch_size: int, rng: np.random.Generator, name: str):
    """(time slot, env) indices of ``batch_size`` valid transitions: the newest slot is excluded,
    its "next" slot not being written yet (or holding the ring's oldest frame when full)."""
    if full:
        idx = (rng.integers(0, capacity - 1, batch_size) + pos) % capacity
    else:
        if pos < 2:
            # with a single written slot, slot 0's ring-successor is still unwritten
            raise ValueError(f"{name}.sample needs at least two written time slots")
        idx = rng.integers(0, pos - 1, batch_size)
    return idx, rng.integers(0, n_envs, batch_size)


class ReplayBuffer:
    def __init__(self, capacity: int, n_envs: int, obs_space, action_dim: int):
        self.capacity = max(capacity // n_envs, 1)
        self.n_envs = n_envs
        self.obs = {}
        self._obs_dtypes = {}
        for k, sp in obs_space.spaces.items():
            store = _STORE_DTYPES.get(np.dtype(sp.dtype), sp.dtype)
            self.obs[k] = np.zeros((self.capacity, n_envs, *sp.shape), store)
            self._obs_dtypes[k] = sp.dtype
        self.actions = np.zeros((self.capacity, n_envs, action_dim), np.float32)
        self.rewards = np.zeros((self.capacity, n_envs), np.float32)
        self.dones = np.zeros((self.capacity, n_envs), np.float32)
        self.timeouts = np.zeros((self.capacity, n_envs), np.float32)
        self._timeout_obs: dict[tuple[int, int], dict] = {}
        self.pos = 0
        self.full = False

    def __len__(self):
        return (self.capacity if self.full else self.pos) * self.n_envs

    def add(self, obs: dict, actions, rewards, dones, infos) -> None:
        p = self.pos
        for k in self.obs:
            self.obs[k][p] = obs[k]
        self.actions[p] = actions
        self.rewards[p] = rewards
        self.dones[p] = np.asarray(dones).astype(np.float32)
        for e, info in enumerate(infos):
            timeout = bool(info.get("TimeLimit.truncated", False))
            self.timeouts[p, e] = float(timeout)
            key = (p, e)
            if timeout and "terminal_observation" in info:
                self._timeout_obs[key] = info["terminal_observation"]
            else:
                self._timeout_obs.pop(key, None)
        self.pos += 1
        if self.pos == self.capacity:
            self.full = True
            self.pos = 0

    def sample(self, batch_size: int, rng: np.random.Generator) -> dict:
        """A minibatch of numpy arrays: obs and next_obs in their obs dtypes, actions, rewards,
        and dones * (1 - timeouts)."""
        idx, env_idx = _ring_indices(self.full, self.pos, self.capacity, self.n_envs, batch_size, rng, "ReplayBuffer")
        next_idx = (idx + 1) % self.capacity

        def get_obs(k, rows, envs):
            return self.obs[k][rows, envs].astype(self._obs_dtypes[k])

        obs = {k: get_obs(k, idx, env_idx) for k in self.obs}
        next_obs = {k: get_obs(k, next_idx, env_idx) for k in self.obs}
        # patch truncated transitions with their stored terminal observation
        for j in range(batch_size):
            key = (int(idx[j]), int(env_idx[j]))
            if self.timeouts[idx[j], env_idx[j]] and key in self._timeout_obs:
                term = self._timeout_obs[key]
                for k in next_obs:
                    next_obs[k][j] = term[k]
        # SB3 handle_timeout_termination: a timeout is not terminal
        dones = self.dones[idx, env_idx] * (1.0 - self.timeouts[idx, env_idx])
        return {
            "obs": obs,
            "next_obs": next_obs,
            "actions": self.actions[idx, env_idx],
            "rewards": self.rewards[idx, env_idx],
            "dones": dones.astype(np.float32),
        }


class DeviceReplayBuffer:
    """The replay ring in device memory (see the module docstring). ``device`` defaults to cuda;
    tests pass ``cpu``. The timeout ring must be large enough that an entry is not overwritten
    while its transition is still sampleable: timeout_capacity >= capacity * n_envs /
    min_episode_length."""

    def __init__(self, capacity: int, n_envs: int, obs_space, action_dim: int, timeout_capacity: int = 4096, device=None):
        self.device = dev = resolve_device(device)
        self.capacity = max(capacity // n_envs, 1)
        self.n_envs = n_envs
        self._obs_dtypes, self._obs_shapes = {}, {}
        obs, tobs = {}, {}
        for k, sp in obs_space.spaces.items():
            dtype = np.dtype(sp.dtype)
            store = torch.bfloat16 if dtype in (np.dtype(np.float32), np.dtype(np.float16)) else _TORCH_DTYPES[dtype]
            flat = int(np.prod(sp.shape))
            obs[k] = torch.zeros((self.capacity, n_envs, flat), dtype=store, device=dev)
            tobs[k] = torch.zeros((timeout_capacity, flat), dtype=store, device=dev)
            self._obs_dtypes[k] = _TORCH_DTYPES[dtype]
            self._obs_shapes[k] = tuple(sp.shape)
        self._state = {
            "obs": obs,
            "actions": torch.zeros((self.capacity, n_envs, action_dim), dtype=torch.float32, device=dev),
            "rewards": torch.zeros((self.capacity, n_envs), dtype=torch.float32, device=dev),
            "dones": torch.zeros((self.capacity, n_envs), dtype=torch.float32, device=dev),
            "timeouts": torch.zeros((self.capacity, n_envs), dtype=torch.float32, device=dev),
            "timeout_obs": tobs,
            "timeout_slot": torch.full((self.capacity, n_envs), -1, dtype=torch.int64, device=dev),
        }
        self.timeout_capacity = timeout_capacity
        self._timeout_pos = 0
        # the global write count at each timeout slot's last allocation, to warn when the ring
        # wraps onto a slot whose transition is still sampleable
        self._slot_alloc_write = np.full(timeout_capacity, np.iinfo(np.int64).min, np.int64)
        self._write_count = 0
        self.pos = 0
        self.full = False

    def __len__(self):
        return (self.capacity if self.full else self.pos) * self.n_envs

    # numpy views for checkpoints (CheckpointCallback's np.savez)
    @property
    def actions(self) -> np.ndarray:
        return self._state["actions"].cpu().numpy()

    @property
    def rewards(self) -> np.ndarray:
        return self._state["rewards"].cpu().numpy()

    @property
    def dones(self) -> np.ndarray:
        return self._state["dones"].cpu().numpy()

    @property
    def timeouts(self) -> np.ndarray:
        return self._state["timeouts"].cpu().numpy()

    @property
    def obs(self) -> dict:
        """Each obs ring at its obs shape; bf16 storage is cast to float32 (lossless from bf16, and
        a dtype np.load reads back, where a float16 view would saturate above 65504)."""
        def view(v: torch.Tensor) -> np.ndarray:
            return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()

        return {k: view(v).reshape((self.capacity, self.n_envs) + self._obs_shapes[k]) for k, v in self._state["obs"].items()}

    def _put(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device, dtype)

    def add(self, obs: dict, actions, rewards, dones, infos) -> None:
        p = self.pos
        state = self._state
        slot_row = np.full((self.n_envs,), -1, np.int64)
        for e, info in enumerate(infos):
            if bool(info.get("TimeLimit.truncated", False)) and "terminal_observation" in info:
                tpos = self._timeout_pos
                self._timeout_pos = (tpos + 1) % self.timeout_capacity
                # the previous tenant of this slot is still sampleable if the main ring has not
                # wrapped past its row yet (int64.min marks a slot never allocated; compare in
                # Python ints, as numpy int64 subtraction would wrap)
                prev_alloc = int(self._slot_alloc_write[tpos])
                if prev_alloc != np.iinfo(np.int64).min and self._write_count - prev_alloc < self.capacity:
                    warnings.warn(
                        f"DeviceReplayBuffer timeout ring wrapped after {self._write_count - self._slot_alloc_write[tpos]} "
                        f"writes (< capacity {self.capacity}): a live truncated transition's next_obs is being "
                        f"overwritten. Raise timeout_capacity (currently {self.timeout_capacity}).",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                self._slot_alloc_write[tpos] = self._write_count
                slot_row[e] = tpos
                for k, v in info["terminal_observation"].items():
                    ring = state["timeout_obs"][k]
                    ring[tpos] = self._put(v, ring.dtype).reshape(-1)
        for k, v in obs.items():
            ring = state["obs"][k]
            ring[p] = self._put(v, ring.dtype).reshape(self.n_envs, -1)
        state["actions"][p] = self._put(actions, torch.float32)
        state["rewards"][p] = self._put(rewards, torch.float32)
        state["dones"][p] = self._put(dones, torch.float32)
        state["timeouts"][p] = self._put([float(i.get("TimeLimit.truncated", False)) for i in infos], torch.float32)
        state["timeout_slot"][p] = torch.from_numpy(slot_row).to(self.device)
        self.pos += 1
        self._write_count += 1
        if self.pos == self.capacity:
            self.full = True
            self.pos = 0

    def sample_indices(self, batch_size: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        """Valid (time slot, env) sample indices, drawn without gathering."""
        return _ring_indices(self.full, self.pos, self.capacity, self.n_envs, batch_size, rng, "DeviceReplayBuffer")

    def gather(self, idx, env_idx) -> dict:
        """The minibatch of the (time slot, env) indices, gathered on the device: obs and next_obs
        at their obs shapes (bf16 storage cast back to the obs dtype), the terminal obs in place of
        next_obs for truncated transitions, actions, rewards and dones * (1 - timeouts)."""
        state = self._state
        idx, env_idx = (torch.as_tensor(np.asarray(i), dtype=torch.int64).to(self.device) for i in (idx, env_idx))
        nxt = (idx + 1) % self.capacity
        slot = state["timeout_slot"][idx, env_idx]
        use_t = (slot >= 0)[:, None]
        safe = slot.clamp(min=0)

        def shaped(k, v):
            return v.reshape((v.shape[0],) + self._obs_shapes[k]).to(self._obs_dtypes[k])

        obs, next_obs = {}, {}
        for k, ring in state["obs"].items():
            obs[k] = shaped(k, ring[idx, env_idx])
            next_obs[k] = shaped(k, torch.where(use_t, state["timeout_obs"][k][safe], ring[nxt, env_idx]))
        dones = state["dones"][idx, env_idx] * (1.0 - state["timeouts"][idx, env_idx])
        return {
            "obs": obs,
            "next_obs": next_obs,
            "actions": state["actions"][idx, env_idx],
            "rewards": state["rewards"][idx, env_idx],
            "dones": dones,
        }

    def sample(self, batch_size: int, rng: np.random.Generator) -> dict:
        return self.gather(*self.sample_indices(batch_size, rng))
