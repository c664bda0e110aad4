"""Vectorized env pools (host numpy; the port's own copy of ``m3l_tpu/envs/vec.py``).

* :class:`SyncVecEnv`: an in-process loop;
* :class:`SubprocVecEnv`: one process per env over pipes;
* :class:`~.shm_vec.SharedMemoryVecEnv` (``envs/shm_vec.py``): one process per env, the
  observations written into shared memory; :func:`make_vec_env` picks it or the loop.

SB3 VecEnv step semantics: auto-reset on done, ``terminal_observation`` and
``TimeLimit.truncated`` in the infos, and Monitor-style ``episode`` stats {r, l, s} over the
raw rewards. The process pools start their workers with ``spawn``, not the JAX package's
``fork``: the training process holds CUDA and thread pools, which a forked child must not
inherit. So the env thunks must pickle (``make_env``'s do).
"""
from __future__ import annotations

import multiprocessing as mp
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
            o, r, done, info = _step_env(env, self._monitors[i], actions[i])
            obs_list.append(o)
            rewards.append(r)
            dones.append(done)
            infos.append(info)
        return _stack_obs(obs_list), np.asarray(rewards, np.float32), np.asarray(dones, bool), infos

    def close(self) -> None:
        for env in self.envs:
            env.close()


def _step_env(env, monitor: _Monitor, action):
    """One step with auto-reset and the episode bookkeeping; returns (obs, reward, done, info)."""
    o, r, term, trunc, info = env.step(action)
    monitor.step(r, info)
    done = term or trunc
    info = dict(info)
    if done:
        info["terminal_observation"] = o
        info["TimeLimit.truncated"] = bool(trunc and not term)
        info["episode"] = monitor.pop()
        o, _ = env.reset()
    return o, r, done, info


def _worker(remote, parent_remote, env_fn):
    parent_remote.close()
    env = env_fn()
    monitor = _Monitor()
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                remote.send(_step_env(env, monitor, data))
            elif cmd == "reset":
                o, _ = env.reset(seed=data)
                remote.send(o)
            elif cmd == "get_spaces":
                remote.send((env.observation_space, env.action_space))
            elif cmd == "close":
                env.close()
                remote.close()
                break
    except (KeyboardInterrupt, EOFError):
        pass


def close_workers(remotes, processes, timeout: float = 5.0) -> None:
    """Ask every worker to close, then join it; one that does not exit in time is terminated."""
    for r in remotes:
        try:
            r.send(("close", None))
        except (BrokenPipeError, EOFError, OSError):
            pass
    for p in processes:
        p.join(timeout=timeout)
        if p.is_alive():
            p.terminate()
            p.join(timeout=timeout)
    for r in remotes:
        r.close()


class SubprocVecEnv:
    def __init__(self, env_fns: Sequence[Callable]):
        ctx = mp.get_context("spawn")
        self.num_envs = len(env_fns)
        self.remotes, work_remotes = zip(*[ctx.Pipe() for _ in range(self.num_envs)])
        self.processes = []
        for wr, r, fn in zip(work_remotes, self.remotes, env_fns):
            p = ctx.Process(target=_worker, args=(wr, r, fn), daemon=True)
            p.start()
            wr.close()
            self.processes.append(p)
        self.remotes[0].send(("get_spaces", None))
        self.observation_space, self.action_space = self.remotes[0].recv()

    def reset(self, seed: int | None = None) -> dict:
        for i, r in enumerate(self.remotes):
            r.send(("reset", None if seed is None else seed + i))
        return _stack_obs([r.recv() for r in self.remotes])

    def step(self, actions: np.ndarray):
        for r, a in zip(self.remotes, actions):
            r.send(("step", a))
        obs, rewards, dones, infos = zip(*[r.recv() for r in self.remotes])
        return _stack_obs(obs), np.asarray(rewards, np.float32), np.asarray(dones, bool), list(infos)

    def close(self) -> None:
        close_workers(self.remotes, self.processes)


def make_vec_env(env_fns: Sequence[Callable], subproc: bool = True):
    """The shared-memory process pool below 100 envs, else the in-process loop (the reference's
    SubprocVecEnv / DummyVecEnv switch)."""
    if subproc and len(env_fns) < 100:
        from .shm_vec import SharedMemoryVecEnv

        return SharedMemoryVecEnv(env_fns)
    return SyncVecEnv(env_fns)
