"""PPO with interleaved MAE representation learning (counterpart of ``m3l_tpu/rl/ppo_mae.py``
``PPOMAE``).

The update phase is GAE, then ``n_epochs`` permutations of the buffer cut into minibatches; each
minibatch indexes the device-resident rollout and packs it with ``vt_load``. Three modes, as in
the JAX package:

* joint (the default): one Adam step on grad(ppo_loss + mae_loss) with one global-norm clip, the
  policy features and the MAE loss sharing one token pipeline;
* separate (``separate_optimizer=True`` with ``train_mae``): ``batch_size // mae_batch_size``
  MAE chunk updates through their own Adam (``mae_lr``, eps 1e-8, no clip) over the MAE's
  parameters, then the clipped PPO step over all parameters;
* plain PPO (``train_mae=False``): the PPO step alone, ``mae_loss`` reported as 0.

``target_kl`` gates the PPO steps: a minibatch whose ``approx_kl`` exceeds ``1.5 * target_kl``
applies no PPO update, and no minibatch after it runs (the JAX scan masks them to no-ops; its
MAE chunks of the stopping minibatch are applied, and so they are here). Metrics are averaged
over the executed updates. The JAX package fuses the phase into one jitted ``lax.scan``; here it
is an eager loop, and the gate reads ``approx_kl`` on the host once per minibatch.

SB3 semantics kept: advantages normalized per minibatch with the ddof=1 std; unclipped actions
stored; the truncated-episode value bootstrap applied to normalized rewards; rewards normalized
by the running-return std.

Random numbers (actions, permutations, masks) come from one ``torch.Generator`` on the device,
seeded from ``seed``; they never match JAX's. :meth:`train_phase` takes the permutation and the
masks as arguments, so a test can hand in its own. Checkpoints (:meth:`save`, :meth:`load`) are
torch state dicts, with the reward normalizer's state in a ``.vecnorm.pkl`` file beside them;
loading puts every tensor on this model's device.
"""
from __future__ import annotations

import os
import pickle
import time
from collections import deque

import numpy as np
import torch

from ..ops.masking import ModalMask
from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.optim import FlatAdam
from ..utils.device import resolve_device
from ..utils.obs import vt_load
from .buffer import RolloutBuffer
from .gae import compute_gae
from .policy import ActorCritic
from .vecnorm import RewardNormalizer

METRICS = ("policy_loss", "value_loss", "entropy_loss", "approx_kl", "clip_fraction", "loss", "mae_loss")


class PPOMAE:
    def __init__(
        self,
        policy: ActorCritic,
        env,
        *,
        learning_rate: float = 1e-4,
        n_steps: int = 2048,
        batch_size: int = 512,
        n_epochs: int = 10,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        clip_range: float = 0.2,
        clip_range_vf: float | None = None,
        normalize_advantage: bool = True,
        ent_coef: float = 0.0,
        vf_coef: float = 0.5,
        max_grad_norm: float = 0.5,
        target_kl: float | None = None,
        mae_batch_size: int = 32,
        separate_optimizer: bool = False,
        train_mae: bool = True,
        mae_lr: float = 1e-4,
        norm_reward: bool = True,
        frame_stack: int = 1,
        seed: int = 0,
        verbose: int = 0,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.env = env
        self.n_envs = env.num_envs
        self.n_steps = n_steps
        self.n_epochs = n_epochs
        self.gamma = gamma
        self.gae_lambda = gae_lambda
        self.clip_range = clip_range
        self.clip_range_vf = clip_range_vf
        self.normalize_advantage = normalize_advantage
        self.ent_coef = ent_coef
        self.vf_coef = vf_coef
        self.target_kl = target_kl
        self.mae_batch_size = mae_batch_size
        self.separate_optimizer = separate_optimizer and train_mae
        self.train_mae = train_mae
        self.frame_stack = frame_stack
        self.verbose = verbose

        n = n_steps * self.n_envs
        if n % batch_size != 0:
            # equal minibatches, as the JAX scan needs: the largest size that divides the buffer
            batch_size = max(b for b in range(1, batch_size + 1) if n % b == 0)
            if verbose:
                print(f"[ppo_mae] batch_size adjusted to {batch_size} (buffer {n})")
        self.batch_size = batch_size
        self.n_minibatches = n // batch_size

        self.policy = policy.to(self.device)
        self.optimizer = FlatAdam(self.policy.parameters(), learning_rate, eps=1e-5, max_grad_norm=max_grad_norm)
        # the reference's mae_optimizer: Adam over the MAE's parameters only, no clip
        self.mae_optimizer = FlatAdam(self.policy.features.mae.parameters(), mae_lr) if self.separate_optimizer else None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.reward_normalizer = RewardNormalizer(self.n_envs, gamma=gamma, enabled=norm_reward)
        self.buffer = RolloutBuffer(n_steps, self.n_envs, env.observation_space, env.action_space.shape[0])
        self._action_low = env.action_space.low
        self._action_high = env.action_space.high

        self.num_timesteps = 0
        self.iteration = 0
        self.ep_info_buffer: deque = deque(maxlen=100)
        self.iteration_seconds: list[dict] = []  # {"collect": s, "train": s} per learn iteration
        self._last_obs = None
        self._last_episode_starts = np.ones(self.n_envs, np.float32)

    def _to_device(self, obs: dict) -> dict:
        return {k: torch.as_tensor(np.ascontiguousarray(v)).to(self.device) for k, v in obs.items()}

    # ------------------------------------------------------------------ #
    # the update phase
    # ------------------------------------------------------------------ #
    def _ppo_losses(self, values, log_prob, entropy, old_values, old_log_prob, advantages, returns):
        if self.normalize_advantage:
            advantages = (advantages - advantages.mean()) / (advantages.std(correction=1) + 1e-8)
        ratio = torch.exp(log_prob - old_log_prob)
        pl1 = advantages * ratio
        pl2 = advantages * torch.clamp(ratio, 1.0 - self.clip_range, 1.0 + self.clip_range)
        policy_loss = -torch.minimum(pl1, pl2).mean()
        if self.clip_range_vf is None:
            values_pred = values
        else:
            values_pred = old_values + torch.clamp(values - old_values, -self.clip_range_vf, self.clip_range_vf)
        value_loss = ((returns - values_pred) ** 2).mean()
        entropy_loss = -entropy.mean()
        total = policy_loss + self.ent_coef * entropy_loss + self.vf_coef * value_loss
        log_ratio = log_prob - old_log_prob
        approx_kl = (torch.exp(log_ratio) - 1.0 - log_ratio).mean()
        clip_fraction = ((ratio - 1.0).abs() > self.clip_range).float().mean()
        metrics = dict(policy_loss=policy_loss, value_loss=value_loss, entropy_loss=entropy_loss,
                       approx_kl=approx_kl, clip_fraction=clip_fraction, loss=total)
        return total, metrics

    def _mae_chunk_updates(self, x: dict, masks: list[ModalMask]) -> torch.Tensor:
        """Separate mode: one MAE Adam step per chunk of ``mae_batch_size`` samples of the packed
        minibatch, chunk i with ``masks[i]``; returns the last chunk's loss."""
        bs = self.mae_batch_size
        for i, mask in enumerate(masks):
            loss = self.policy.features.mae_loss({k: v[i * bs : (i + 1) * bs] for k, v in x.items()}, mask)
            self.mae_optimizer.zero_grad()
            loss.backward()
            self.mae_optimizer.step()
        return loss.detach()

    def minibatch_update(self, data: dict, idx: torch.Tensor, advantages: torch.Tensor, returns: torch.Tensor, mask) -> dict | None:
        """One update on the samples ``idx`` of the device-resident rollout. ``mask`` is the MAE
        mask: one :class:`ModalMask` in joint mode, one per MAE chunk in separate mode, None for
        plain PPO. Returns the step's metrics as detached device scalars, or None when the
        ``target_kl`` gate stops it (then no PPO update is applied)."""
        x = vt_load({k: v[idx] for k, v in data["obs"].items()}, frame_stack=self.frame_stack)
        actions = data["actions"][idx]
        joint = self.train_mae and not self.separate_optimizer
        if self.separate_optimizer:
            mae_loss = self._mae_chunk_updates(x, mask)
        if joint:
            values, log_prob, entropy, mae_loss = self.policy.evaluate_actions_packed_with_mae(x, actions, mask)
        else:
            values, log_prob, entropy = self.policy.evaluate_actions_packed(x, actions)
        if not self.train_mae:
            mae_loss = torch.zeros((), device=self.device)
        total, metrics = self._ppo_losses(
            values, log_prob, entropy, data["values"][idx], data["log_probs"][idx], advantages[idx], returns[idx]
        )
        if self.target_kl is not None and not bool(metrics["approx_kl"] <= 1.5 * self.target_kl):
            return None
        self.optimizer.zero_grad()
        (total + mae_loss if joint else total).backward()
        self.optimizer.step()
        metrics["mae_loss"] = mae_loss
        return {k: v.detach() for k, v in metrics.items()}

    def train_phase(
        self,
        data: dict,
        rewards: torch.Tensor,
        episode_starts: torch.Tensor,
        last_values: torch.Tensor,
        last_dones: torch.Tensor,
        idx: torch.Tensor,
        masks: list,
    ) -> dict:
        """GAE, then one update per row of ``idx`` (n_updates, batch) with the matching entry of
        ``masks`` (see :meth:`minibatch_update`), until the ``target_kl`` gate stops. Returns the
        metrics averaged over the executed updates (0 if none ran), their count and the
        explained variance."""
        t_len, e_len = rewards.shape
        adv, ret = compute_gae(rewards, data["values"].reshape(t_len, e_len), episode_starts, last_values, last_dones,
                               self.gamma, self.gae_lambda)
        advantages_all, returns_all = adv.reshape(-1), ret.reshape(-1)
        steps = []
        for i, m in zip(idx, masks):
            metrics = self.minibatch_update(data, i, advantages_all, returns_all, m)
            if metrics is None:
                break
            steps.append(metrics)
        zero = torch.zeros((), device=self.device)
        out = {k: torch.stack([s[k] for s in steps]).mean() if steps else zero for k in METRICS}
        out["n_updates_executed"] = torch.tensor(float(len(steps)))
        var_ret = returns_all.var(correction=0)
        out["explained_variance"] = torch.where(
            var_ret > 0, 1.0 - (returns_all - data["values"]).var(correction=0) / var_ret, torch.nan
        )
        return {k: float(v) for k, v in out.items()}

    def sample_updates(self, obs_keys) -> tuple[torch.Tensor, list]:
        """The update phase's randomness from the generator: one permutation of the buffer per
        epoch, cut into minibatches, and each minibatch's MAE mask (one in joint mode, one per
        chunk in separate mode, None for plain PPO) over the modalities the features' MAE sees."""
        n = self.n_steps * self.n_envs
        perms = [torch.randperm(n, generator=self.generator, device=self.device) for _ in range(self.n_epochs)]
        idx = torch.stack(perms).reshape(self.n_epochs * self.n_minibatches, self.batch_size)
        if not self.train_mae:  # plain PPO: the features need no MAE
            return idx, [None] * len(idx)
        features = self.policy.features
        use_vision, use_tactile = features.mae_modalities(obs_keys)

        def draw(batch):
            return features.mae.sample_mask(self.generator, batch, use_vision=use_vision, use_tactile=use_tactile)

        if self.separate_optimizer:
            chunks = max(self.batch_size // self.mae_batch_size, 1)
            return idx, [[draw(self.mae_batch_size) for _ in range(chunks)] for _ in range(len(idx))]
        return idx, [draw(self.batch_size) for _ in range(len(idx))]

    def train(self) -> dict:
        data = self.buffer.to_device(self.device)
        with torch.inference_mode():
            last_values = self.policy.predict_values(self._to_device(self._last_obs))
        idx, masks = self.sample_updates(data["obs"].keys())
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        return self.train_phase(
            data, put(self.buffer.rewards), put(self.buffer.episode_starts), last_values.clone(),
            put(self._last_episode_starts), idx, masks,
        )

    # ------------------------------------------------------------------ #
    # rollout collection (host env loop, device inference)
    # ------------------------------------------------------------------ #
    def collect_rollouts(self) -> None:
        if self._last_obs is None:
            self._last_obs = self.env.reset()
        self.buffer.reset()
        while not self.buffer.full:
            with torch.inference_mode():
                actions, values, log_probs = self.policy.step(self._to_device(self._last_obs), self.generator)
            actions = actions.cpu().numpy()
            clipped = np.clip(actions, self._action_low, self._action_high)
            new_obs, rewards, dones, infos = self.env.step(clipped)
            self.num_timesteps += self.n_envs

            rewards = self.reward_normalizer(rewards, dones)
            # truncated-episode bootstrap (SB3 OnPolicyAlgorithm semantics)
            trunc_idx = [
                i
                for i, (d, info) in enumerate(zip(dones, infos))
                if d and info.get("TimeLimit.truncated", False) and "terminal_observation" in info
            ]
            if trunc_idx:
                term_obs = {
                    k: np.stack([infos[i]["terminal_observation"][k] if i in trunc_idx else self._last_obs[k][i] for i in range(self.n_envs)])
                    for k in self._last_obs
                }
                with torch.inference_mode():
                    term_values = self.policy.predict_values(self._to_device(term_obs)).cpu().numpy()
                for i in trunc_idx:
                    rewards[i] += self.gamma * term_values[i]

            for info in infos:
                if "episode" in info:
                    self.ep_info_buffer.append(info["episode"])

            self.buffer.add(self._last_obs, actions, rewards, self._last_episode_starts, values.cpu().numpy(), log_probs.cpu().numpy())
            self._last_obs = new_obs
            self._last_episode_starts = dones.astype(np.float32)

    def learn(self, total_timesteps: int, callback=None, log_interval: int = 1):
        t_start = time.time()
        while self.num_timesteps < total_timesteps:
            t0 = time.time()
            self.collect_rollouts()
            t_collect = time.time() - t0
            if callback is not None and callback(self) is False:
                break
            t0 = time.time()
            metrics = self.train()
            t_train = time.time() - t0
            self.iteration += 1
            self.iteration_seconds.append({"collect": t_collect, "train": t_train})
            if self.verbose and self.iteration % log_interval == 0:
                ep_rew = np.mean([e["r"] for e in self.ep_info_buffer]) if self.ep_info_buffer else float("nan")
                ep_len = np.mean([e["l"] for e in self.ep_info_buffer]) if self.ep_info_buffer else float("nan")
                ep_suc = np.mean([e.get("s", 0.0) for e in self.ep_info_buffer]) if self.ep_info_buffer else float("nan")
                fps = int(self.num_timesteps / (time.time() - t_start))
                print(
                    f"[iter {self.iteration}] steps={self.num_timesteps} fps={fps} "
                    f"ep_rew_mean={ep_rew:.2f} ep_len_mean={ep_len:.1f} success_rate={ep_suc:.2f} "
                    f"collect={t_collect:.1f}s train={t_train:.1f}s "
                    + " ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                )
            self.last_metrics = metrics
        return self

    def predict(self, obs: dict, deterministic: bool = True) -> np.ndarray:
        with torch.inference_mode():
            if deterministic:
                actions = self.policy._dist_params(self._to_device(obs))[0]
            else:
                actions = self.policy.step(self._to_device(obs), self.generator)[0]
        return np.clip(actions.cpu().numpy(), self._action_low, self._action_high)

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #
    def state_dict(self) -> dict:
        return {
            "policy": self.policy.state_dict(),
            "policy_opt_state": self.optimizer.state_dict(),
            "mae_opt_state": None if self.mae_optimizer is None else self.mae_optimizer.state_dict(),
            "reward_normalizer": self.reward_normalizer.state_dict(),
            "num_timesteps": self.num_timesteps,
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore a :meth:`state_dict` into this (architecture-compatible) model; parameters and
        optimizer moments are copied onto this model's device."""
        self.policy.load_state_dict(d["policy"])
        self.optimizer.load_state_dict(d["policy_opt_state"])
        if d.get("mae_opt_state") is not None and self.mae_optimizer is not None:
            self.mae_optimizer.load_state_dict(d["mae_opt_state"])
        if "reward_normalizer" in d:
            self.reward_normalizer.load_state_dict(d["reward_normalizer"])
        self.num_timesteps = int(d["num_timesteps"])

    def save(self, path: str) -> None:
        """Write the model, optimizer and normalizer state: ``path`` and ``path.vecnorm.pkl``
        (SB3 ``model.save`` plus ``CheckpointCallback``'s ``save_vecnormalize``)."""
        sd = self.state_dict()
        normalizer = sd.pop("reward_normalizer")
        save_checkpoint(path, sd)
        with open(f"{path}.vecnorm.pkl", "wb") as f:
            pickle.dump(normalizer, f)

    def load(self, path: str) -> None:
        """Restore a checkpoint written by :meth:`save` (or ``CheckpointCallback``), its tensors
        mapped to this model's device."""
        self.load_state_dict(load_checkpoint(path, map_location=self.device))
        vn = f"{path}.vecnorm.pkl"
        if os.path.isfile(vn):
            with open(vn, "rb") as f:
                self.reward_normalizer.load_state_dict(pickle.load(f))
