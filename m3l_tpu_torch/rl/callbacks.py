"""RL training callbacks (the port's copy of ``m3l_tpu/rl/callbacks.py``).

* :class:`CheckpointCallback`: periodic ``model_<steps>_steps.ckpt`` saves with the reward
  normalizer's state beside them (the reference's ``save_vecnormalize=True``) and, for
  off-policy algorithms, optionally the replay buffer (``save_replay_buffer``);
* :class:`TensorboardCallback`: the last update's metrics and the rolling episode return and
  length;
* :class:`CallbackList`.

The protocol is the JAX package's: ``callback(algo) -> bool | None``, called once per learn
iteration after the rollout (PPO) or once per env step (SAC); returning False stops training.
``EvalCallback`` and ``create_callbacks`` (video evaluation) are not ported yet.
"""
from __future__ import annotations

import os

import numpy as np


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def __call__(self, algo):
        ok = True
        for cb in self.callbacks:
            if cb(algo) is False:
                ok = False
        return ok


class CheckpointCallback:
    """Saves ``algo`` (its :meth:`save`) every ``save_freq`` environment steps, as
    ``model_<steps>_steps.ckpt``: the names ``train.checkpoint.step_checkpoints`` finds. With
    ``save_replay_buffer`` an algorithm's replay buffer goes beside it as numpy arrays in
    ``<name>.replay.npz`` (large by design, as the reference's ``save_replay_buffer=True``)."""

    def __init__(self, save_freq: int, save_path: str, save_replay_buffer: bool = False):
        self.save_freq = save_freq
        self.save_path = save_path
        self.save_replay_buffer = save_replay_buffer
        self._last_save = 0

    def __call__(self, algo):
        if algo.num_timesteps - self._last_save < self.save_freq:
            return True
        self._last_save = algo.num_timesteps
        path = os.path.join(self.save_path, f"model_{algo.num_timesteps}_steps.ckpt")
        algo.save(path)
        buf = getattr(algo, "buffer", None)
        if self.save_replay_buffer and hasattr(buf, "dones"):
            np.savez_compressed(
                path + ".replay.npz", pos=buf.pos, full=buf.full, actions=buf.actions, rewards=buf.rewards,
                dones=buf.dones, timeouts=buf.timeouts, **{f"obs_{k}": v for k, v in buf.obs.items()},
            )
        return True


class TensorboardCallback:
    """The last update's metrics and the rolling episode return and length, to ``logger``."""

    def __init__(self, logger):
        self.logger = logger

    def __call__(self, algo):
        metrics = dict(getattr(algo, "last_metrics", {}) or {})
        if algo.ep_info_buffer:
            metrics["rollout/ep_rew_mean"] = float(np.mean([e["r"] for e in algo.ep_info_buffer]))
            metrics["rollout/ep_len_mean"] = float(np.mean([e["l"] for e in algo.ep_info_buffer]))
        self.logger.log_scalars(metrics, algo.num_timesteps)
        return True
