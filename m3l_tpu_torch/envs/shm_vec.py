"""Shared-memory vectorized env pool (the port's own copy of ``m3l_tpu/envs/shm_vec.py``).

Each worker writes its observation straight into a preallocated ``multiprocessing.shared_memory``
block; the parent reads the batch from numpy views, with no pickling of observations. Rewards,
dones and infos still travel the pipe. Workers start with ``spawn`` (see ``envs/vec.py``).
"""
from __future__ import annotations

import multiprocessing as mp
from multiprocessing import shared_memory
from typing import Callable, Sequence

import numpy as np

from .vec import _Monitor, _step_env, close_workers


def _worker(remote, parent_remote, env_fn, shm_names, shapes, dtypes, idx):
    parent_remote.close()
    env = env_fn()
    monitor = _Monitor()
    shms = {k: shared_memory.SharedMemory(name=name) for k, name in shm_names.items()}
    views = {k: np.ndarray(shapes[k], dtype=dtypes[k], buffer=shms[k].buf) for k in shm_names}

    def write_obs(obs):
        for k, v in obs.items():
            views[k][idx] = v

    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                o, r, done, info = _step_env(env, monitor, data)
                write_obs(o)
                remote.send((r, done, info))
            elif cmd == "reset":
                o, _ = env.reset(seed=data)
                write_obs(o)
                remote.send(True)
            elif cmd == "close":
                env.close()
                remote.close()
                break
    except (KeyboardInterrupt, EOFError):
        pass
    finally:
        views.clear()
        for s in shms.values():
            s.close()


class SharedMemoryVecEnv:
    def __init__(self, env_fns: Sequence[Callable]):
        ctx = mp.get_context("spawn")
        self.num_envs = len(env_fns)
        probe = env_fns[0]()
        self.observation_space = probe.observation_space
        self.action_space = probe.action_space
        probe.close()

        self._shms = {}
        self._views = {}
        shapes, dtypes, names = {}, {}, {}
        for k, sp in self.observation_space.spaces.items():
            shape = (self.num_envs, *sp.shape)
            shm = shared_memory.SharedMemory(create=True, size=int(np.prod(shape)) * np.dtype(sp.dtype).itemsize)
            self._shms[k] = shm
            self._views[k] = np.ndarray(shape, dtype=sp.dtype, buffer=shm.buf)
            shapes[k], dtypes[k], names[k] = shape, sp.dtype, shm.name

        self.remotes, work_remotes = zip(*[ctx.Pipe() for _ in range(self.num_envs)])
        self.processes = []
        for i, (wr, fn) in enumerate(zip(work_remotes, env_fns)):
            p = ctx.Process(target=_worker, args=(wr, self.remotes[i], fn, names, shapes, dtypes, i), daemon=True)
            p.start()
            wr.close()
            self.processes.append(p)

    def reset(self, seed: int | None = None) -> dict:
        for i, r in enumerate(self.remotes):
            r.send(("reset", None if seed is None else seed + i))
        for r in self.remotes:
            r.recv()
        return {k: v.copy() for k, v in self._views.items()}

    def step(self, actions: np.ndarray):
        for r, a in zip(self.remotes, actions):
            r.send(("step", a))
        rewards, dones, infos = zip(*[r.recv() for r in self.remotes])
        # copies: the views are overwritten by the next step
        obs = {k: v.copy() for k, v in self._views.items()}
        return obs, np.asarray(rewards, np.float32), np.asarray(dones, bool), list(infos)

    def env_method(self, name, *args, indices=None, **kwargs):
        """Not offered, as in the JAX package: the workers answer only step, reset and close."""
        raise NotImplementedError("use SubprocVecEnv for env_method")

    def close(self) -> None:
        close_workers(self.remotes, self.processes)
        self._views.clear()
        for shm in self._shms.values():
            shm.close()
            shm.unlink()
