"""RL training callbacks (the port's copy of ``m3l_tpu/rl/callbacks.py``).

* :class:`CheckpointCallback`: periodic ``model_<steps>_steps.ckpt`` saves with the reward
  normalizer's state beside them (the reference's ``save_vecnormalize=True``) and, for
  off-policy algorithms, optionally the replay buffer (``save_replay_buffer``);
* :class:`EvalCallback`: one deterministic evaluation episode every ``eval_every`` steps on a
  fresh env, with its return, length and success logged and, with ``video_dir``, an annotated
  video (``utils/video.py``, which needs cv2); gated on ``learning_starts`` for off-policy runs;
* :class:`TensorboardCallback`: the last update's metrics and the rolling episode return and
  length;
* :class:`CallbackList` and :func:`create_callbacks`, the standard wiring.

The protocol is the JAX package's: ``callback(algo) -> bool | None``, called once per learn
iteration after the rollout (PPO) or once per env step (SAC); returning False stops training.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils.video import annotate_frame, write_video


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


class EvalCallback:
    """One deterministic episode of ``eval_env_fn()`` (a single env with the gymnasium step API
    and ``render``) through ``algo.predict`` every ``eval_every`` environment steps, at most
    ``max_steps`` long. Each result {eval/ep_reward, eval/ep_length, eval/success} is kept in
    :attr:`history` and logged; with ``video_dir`` the rendered frames, annotated, go to
    ``eval_<steps>.mp4`` there."""

    def __init__(self, eval_env_fn, *, eval_every: int = int(2e5), video_dir: Optional[str] = None, logger=None,
                 learning_starts: int = 0, max_steps: int = 1000, verbose: int = 0):
        self.eval_env_fn = eval_env_fn
        self.eval_every = eval_every
        self.video_dir = video_dir
        self.logger = logger
        self.learning_starts = learning_starts
        self.max_steps = max_steps
        self.verbose = verbose
        self._last_eval = 0
        self.history: list[dict] = []

    def __call__(self, algo):
        if algo.num_timesteps < self.learning_starts or algo.num_timesteps - self._last_eval < self.eval_every:
            return True
        self._last_eval = algo.num_timesteps
        env = self.eval_env_fn()
        obs, _ = env.reset(seed=0)
        frames, ep_rew, success = [], 0.0, False
        for step in range(self.max_steps):
            action = algo.predict({k: np.asarray(v)[None] for k, v in obs.items()}, deterministic=True)[0]
            obs, rew, term, trunc, info = env.step(action)
            ep_rew += float(rew)
            success = success or bool(info.get("is_success", False))
            if self.video_dir is not None:
                frame = env.render()
                if frame is not None:
                    frames.append(annotate_frame(step, np.asarray(frame), float(rew), {"success": success}))
            if term or trunc:
                break
        env.close()
        result = {"eval/ep_reward": ep_rew, "eval/ep_length": step + 1, "eval/success": float(success)}
        self.history.append(result)
        if self.video_dir and frames:
            result["eval/video"] = write_video(frames, os.path.join(self.video_dir, f"eval_{algo.num_timesteps}.mp4"))
        if self.logger is not None:
            self.logger.log_scalars({k: v for k, v in result.items() if isinstance(v, (int, float))}, algo.num_timesteps)
        if self.verbose:
            print(f"[eval @ {algo.num_timesteps}] reward={ep_rew:.2f} success={success}")
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


def create_callbacks(config, eval_env_fn=None, logger=None, learning_starts: int = 0, save_replay_buffer: bool = False) -> CallbackList:
    """The standard wiring under ``config.wandb_dir``: checkpoints every ``config.save_freq``
    steps in ``checkpoints/``, with ``eval_env_fn`` an evaluation every ``config.eval_every``
    steps with videos in ``videos/``, and with ``logger`` the metrics."""
    save_dir = getattr(config, "wandb_dir", "./runs/")
    cbs = [CheckpointCallback(config.save_freq, os.path.join(save_dir, "checkpoints"), save_replay_buffer=save_replay_buffer)]
    if eval_env_fn is not None:
        cbs.append(EvalCallback(eval_env_fn, eval_every=config.eval_every, video_dir=os.path.join(save_dir, "videos"), logger=logger,
                                learning_starts=learning_starts))
    if logger is not None:
        cbs.append(TensorboardCallback(logger))
    return CallbackList(cbs)
