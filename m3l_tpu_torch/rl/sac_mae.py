"""SAC with interleaved MAE representation learning (counterpart of ``m3l_tpu/rl/sac_mae.py``
``SACMAE``).

One gradient step keeps the JAX package's order exactly (its ``update_body``):

1. MAE update(s) on the replay observations: in separate mode (the default) ``batch //
   mae_batch_size`` chunks, each with its own mask, through the MAE's own Adam (``mae_lr``);
2. actions and log-probs of the current policy, on the post-MAE parameters;
3. ``ent_coef`` read before its own Adam step on ``-mean(log_alpha * sg(logp + target_entropy))``
   (``ent_coef="auto"``; a number fixes it);
4. the critic's MSE against the min-twin target, on stop-gradient features: no gradient reaches
   the extractor;
5. the actor against the updated critic. Separate mode uses the stop-gradient features, so the
   actor's Adam, which covers the actor heads, ``features.post`` and the MAE, sees zero
   gradients for the last two and their moments stay zero, as in the JAX package. Joint mode adds
   the MAE loss of the same batch and trains all three through that one Adam;
6. polyak: ``(1 - tau) * target + tau * critic``, after every step. ``target_update_interval`` is
   accepted and, as in the JAX package, never read.

The features of the batch and of its next observations are computed once per parameter version
(after step 1); the JAX package recomputes them on the same parameters, to the same values.

Randomness is injected. :meth:`update` takes the MAE masks and two noise tensors (the policy's
noise of step 2, reused bit for bit by step 5, and the next-action noise of the TD target);
:meth:`sample_randomness` draws them from the algorithm's ``torch.Generator``, as
``PPOMAE.sample_updates`` draws its masks. Warm-up actions before ``learning_starts`` come from
the action space, sampled with a numpy ``Generator`` the algorithm owns; replay indices come from
another, seeded as the JAX package seeds its own, so both sides draw the same transitions.

``train_steps(n)`` on a :class:`~.replay.DeviceReplayBuffer` draws ``n * batch`` indices on the
host at once and runs ``n`` updates, each gathering its minibatch on the device (the JAX
package's fused ``multi_update``); it returns the last step's metrics. On the host
:class:`~.replay.ReplayBuffer` it loops :meth:`train_step`. The four Adams are
:class:`~..train.optim.FlatAdam` (eps 1e-8, no clipping): actor over (actor heads +
``features.post``, MAE), critic, entropy, and in separate mode the MAE's. Checkpoints
(:meth:`save`, :meth:`load`) are torch state dicts with the reward normalizer's state in a
``.vecnorm.pkl`` file beside them.

Under a ``mesh`` (``train/mesh.py``; JAX's ``mesh=``) the result is the single-process one on the
global batch. The policy (the MAE and ``features.post``; the actor and critic MLPs match no
tensor-parallel rule and stay replicated, as in JAX) is sharded before the Adams are built, and
each Adam sums its gradients over the dp group. Rank 0 owns the envs: every rank picks the
step's actions (collective under mp), rank 0 steps the envs and broadcasts its actions and what
the envs return, so every rank's replay ring, on the host or the device, holds the same
transitions. Every replay index and all noise are drawn up front, identically on every rank;
:meth:`update` takes the global batch and randomness and each rank keeps its dp rows. Each loss
is this rank's share of the global one (its rows' mean times rows / batch), the MAE chunks
included, and the metrics are summed over the ranks. The polyak update is local and
elementwise. Checkpoints are written from rank 0 in the single-process layout; every method that
runs the policy is collective under a mesh.
"""
from __future__ import annotations

import os
import pickle
import time
from collections import deque

import numpy as np
import torch

from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..train.mesh import Mesh, env_spec, gather_state, is_main, on_main, put_batch, shard_module, shard_state, tree_map
from ..train.optim import FlatAdam
from ..utils.device import resolve_device
from ..utils.obs import vt_load
from .replay import DeviceReplayBuffer, ReplayBuffer
from .sac_policy import SACActorCritic
from .vecnorm import RewardNormalizer


def _adam_step(opt: FlatAdam, loss: torch.Tensor) -> None:
    """One Adam step of ``opt`` on the gradient of ``loss`` with respect to its parameters only
    (a parameter the loss does not reach counts zeros, as JAX differentiates it)."""
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    for p, g in zip(opt.params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad()


class SACMAE:
    def __init__(
        self,
        policy: SACActorCritic,
        env,
        *,
        learning_rate: float = 3e-4,
        buffer_size: int = 1_000_000,
        learning_starts: int = 100,
        batch_size: int = 256,
        tau: float = 0.005,
        gamma: float = 0.99,
        train_freq: int = 1,
        gradient_steps: int = 1,
        ent_coef: str | float = "auto",
        target_update_interval: int = 1,
        target_entropy: str | float = "auto",
        mae_batch_size: int = 256,
        separate_optimizer: bool = True,
        mae_lr: float = 1e-4,
        norm_reward: bool = True,
        frame_stack: int = 1,
        device_buffer: bool = False,
        timeout_capacity: int = 4096,
        seed: int = 0,
        verbose: int = 0,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        env = env_spec(env, mesh)
        self.env = env
        self.n_envs = env.num_envs
        self.learning_starts = learning_starts
        self.batch_size = batch_size
        self.tau = tau
        self.gamma = gamma
        self.train_freq = train_freq
        self.gradient_steps = gradient_steps
        self.target_update_interval = target_update_interval  # accepted, never read (as in the JAX package)
        self.mae_batch_size = min(mae_batch_size, batch_size)
        self.separate_optimizer = separate_optimizer
        self.frame_stack = frame_stack
        self.verbose = verbose

        self.action_dim = env.action_space.shape[0]
        self.target_entropy = float(-self.action_dim) if target_entropy == "auto" else float(target_entropy)
        self.auto_ent = isinstance(ent_coef, str) and ent_coef.startswith("auto")
        if not self.auto_ent:
            self.fixed_ent_coef = float(ent_coef)

        self.policy = policy.to(self.device)
        if mesh is not None:
            shard_module(self.policy, mesh)
        p = self.policy
        with torch.no_grad():
            if self.auto_ent:
                init = float(str(ent_coef).split("_")[1]) if "_" in str(ent_coef) else 1.0
                p.log_ent_coef.fill_(float(np.log(init)))
            p.critic_target.load_state_dict(p.critic.state_dict())  # the target starts as a copy
        mae_params = list(p.features.mae.parameters())
        mae_ids = {id(q) for q in mae_params}
        grouped = mae_ids | {id(q) for m in (p.critic, p.critic_target) for q in m.parameters()} | {id(p.log_ent_coef)}
        actor_params = [q for q in p.parameters() if id(q) not in grouped]  # actor heads + features.post
        self.actor_optimizer = FlatAdam(actor_params + mae_params, learning_rate, mesh=mesh)
        self.critic_optimizer = FlatAdam(p.critic.parameters(), learning_rate, mesh=mesh)
        self.ent_optimizer = FlatAdam([p.log_ent_coef], learning_rate, mesh=mesh)
        self.mae_optimizer = FlatAdam(mae_params, mae_lr, mesh=mesh) if separate_optimizer else None

        if device_buffer:
            self.buffer = DeviceReplayBuffer(buffer_size, self.n_envs, env.observation_space, self.action_dim,
                                             timeout_capacity=timeout_capacity, device=self.device)
        else:
            self.buffer = ReplayBuffer(buffer_size, self.n_envs, env.observation_space, self.action_dim)
        self.reward_normalizer = RewardNormalizer(self.n_envs, gamma=gamma, enabled=norm_reward)
        self._action_low = env.action_space.low
        self._action_high = env.action_space.high
        self._use_vision = "image" in env.observation_space.spaces

        self.num_timesteps = 0
        self._n_updates = 0
        self.ep_info_buffer: deque = deque(maxlen=100)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)  # replay indices, as the JAX package draws them
        self._action_rng = np.random.default_rng([seed, 1])  # warm-up actions
        self._last_obs = None
        self.last_metrics: dict = {}

    def _to_device(self, obs: dict) -> dict:
        return {k: torch.as_tensor(np.ascontiguousarray(v)).to(self.device) for k, v in obs.items()}

    @property
    def _is_main(self) -> bool:
        return is_main(self.mesh)

    # ------------------------------------------------------------------ #
    # the gradient step
    # ------------------------------------------------------------------ #
    def sample_randomness(self) -> tuple[list, torch.Tensor, torch.Tensor]:
        """One step's randomness from the generator: the MAE masks (one per chunk in separate
        mode, one for the batch in joint mode), the policy noise and the next-action noise."""
        mae, gen = self.policy.features.mae, self.generator
        if self.separate_optimizer:
            chunks = max(self.batch_size // self.mae_batch_size, 1)
            masks = [mae.sample_mask(gen, self.mae_batch_size, use_vision=self._use_vision) for _ in range(chunks)]
        else:
            masks = [mae.sample_mask(gen, self.batch_size, use_vision=self._use_vision)]
        shape = (self.batch_size, self.action_dim)
        noise_pi = torch.randn(shape, generator=gen, device=self.device)
        noise_next = torch.randn(shape, generator=gen, device=self.device)
        return masks, noise_pi, noise_next

    def update(self, batch: dict, masks: list, noise_pi: torch.Tensor, noise_next: torch.Tensor) -> dict:
        """One gradient step on ``batch`` (tensors on the device: obs, next_obs, actions, rewards,
        dones) with injected randomness (see :meth:`sample_randomness`). Returns the metrics as
        detached device scalars. Under a mesh the batch and the randomness are the global ones;
        this rank keeps its rows and steps on its share of each loss."""
        p = self.policy
        n = batch["actions"].shape[0]
        rows = self.mesh.rows(n) if self.mesh is not None else slice(0, n)
        scale = (rows.stop - rows.start) / n
        if self.mesh is not None:
            batch = put_batch(batch, self.mesh)
            noise_pi, noise_next = noise_pi[rows], noise_next[rows]

        def share(loss):
            return loss if self.mesh is None else loss * scale

        x = vt_load(batch["obs"], frame_stack=self.frame_stack)
        x_next = vt_load(batch["next_obs"], frame_stack=self.frame_stack)
        metrics = {}

        # 1) MAE update(s) on replay observations, each chunk's rows where this rank holds them
        if self.separate_optimizer:
            bs = self.mae_batch_size
            for i, mask in enumerate(masks):
                a, b = max(i * bs, rows.start), min((i + 1) * bs, rows.stop)
                if b > a:
                    chunk_mask = tree_map(lambda t: t[a - i * bs : b - i * bs], mask)  # noqa: B023
                    mae_loss = p.features.mae_loss({k: v[a - rows.start : b - rows.start] for k, v in x.items()}, chunk_mask)
                    if b - a != bs:
                        mae_loss = mae_loss * ((b - a) / bs)
                    _adam_step(self.mae_optimizer, mae_loss)
                else:
                    mae_loss = torch.zeros((), device=self.device)
                    self.mae_optimizer.step()  # no rows here: zero gradients into the dp sum
            metrics["mae_loss"] = mae_loss.detach()

        with torch.no_grad():
            feats_sg = p.features.from_packed(x)
            next_feats = p.features.from_packed(x_next)
            # 2) current-policy log-probs (post-MAE parameters)
            _, log_prob = p.actor.action_log_prob(feats_sg, noise_pi)

        # 3) entropy coefficient, read before its update
        if self.auto_ent:
            ent_coef = torch.exp(p.log_ent_coef.detach())
            target = (log_prob + self.target_entropy).detach()
            _adam_step(self.ent_optimizer, share(-(p.log_ent_coef * target).mean()))
            metrics["ent_coef_loss"] = share(-(torch.log(ent_coef) * target).mean())
        else:
            ent_coef = torch.tensor(self.fixed_ent_coef, device=self.device)
        metrics["ent_coef"] = share(ent_coef)

        # 4) critic update against the min-twin target (no gradient into the extractor)
        with torch.no_grad():
            next_actions, next_logp = p.actor.action_log_prob(next_feats, noise_next)
            next_q = p.critic_target(next_feats, next_actions).min(dim=-1).values - ent_coef * next_logp
            target_q = batch["rewards"] + (1.0 - batch["dones"]) * self.gamma * next_q
        q = p.critic(feats_sg, batch["actions"])
        critic_loss = share(0.5 * ((q - target_q[:, None]) ** 2).mean(dim=0).sum())
        _adam_step(self.critic_optimizer, critic_loss)
        metrics["critic_loss"] = critic_loss.detach()

        # 5) actor update against the refreshed critic; joint mode adds the MAE loss
        if self.separate_optimizer:
            feats = feats_sg
        else:
            feats, mae_loss = p.features.features_and_mae_loss(x, tree_map(lambda t: t[rows], masks[0]))
            mae_loss = share(mae_loss)
        a, logp = p.actor.action_log_prob(feats, noise_pi)
        q_pi = p.critic(feats, a).min(dim=-1).values
        actor_loss = share((ent_coef * logp - q_pi).mean())
        _adam_step(self.actor_optimizer, actor_loss if self.separate_optimizer else actor_loss + mae_loss)
        metrics["actor_loss"] = actor_loss.detach()
        if not self.separate_optimizer:
            metrics["mae_loss"] = mae_loss.detach()

        # 6) polyak target update
        with torch.no_grad():
            for t, c in zip(p.critic_target.parameters(), p.critic.parameters()):
                t.copy_((1.0 - self.tau) * t + self.tau * c)
        self._n_updates += 1
        if self.mesh is not None:
            metrics = dict(zip(metrics, self.mesh.global_mean(torch.stack(list(metrics.values())))))
        return metrics

    def _ready(self) -> bool:
        return len(self.buffer) >= self.batch_size and (self.buffer.full or self.buffer.pos >= 2)

    def train_step(self) -> dict:
        """One gradient step on a minibatch sampled from the buffer (no step, and the last metrics,
        while the buffer is too small)."""
        if not self._ready():
            return self.last_metrics
        batch = self.buffer.sample(self.batch_size, self._np_rng)
        if isinstance(self.buffer, ReplayBuffer):
            batch = {k: self._to_device(v) if isinstance(v, dict) else torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        metrics = self.update(batch, *self.sample_randomness())
        return {k: float(v) for k, v in metrics.items()}

    def train_steps(self, n: int) -> dict:
        """``n`` gradient steps; on a device buffer from one host draw of ``n * batch`` indices,
        each step's minibatch gathered on the device. Returns the last step's metrics."""
        if isinstance(self.buffer, ReplayBuffer):
            metrics = self.last_metrics
            for _ in range(n):
                metrics = self.train_step()
            return metrics
        if not self._ready():
            return self.last_metrics
        idx, env_idx = self.buffer.sample_indices(n * self.batch_size, self._np_rng)
        bs = self.batch_size
        for i in range(n):
            metrics = self.update(self.buffer.gather(idx[i * bs : (i + 1) * bs], env_idx[i * bs : (i + 1) * bs]),
                                  *self.sample_randomness())
        return {k: float(v) for k, v in metrics.items()}

    # ------------------------------------------------------------------ #
    # the env loop
    # ------------------------------------------------------------------ #
    def _act(self, obs: dict) -> np.ndarray:
        if self.num_timesteps < self.learning_starts:
            return np.stack([self.env.action_space.sample(self._action_rng) for _ in range(self.n_envs)])
        return self._sample(obs)

    def _sample(self, obs: dict) -> np.ndarray:
        """Actions sampled with the algorithm's generator, clipped to the action bounds."""
        x = self._to_device(obs)
        with torch.inference_mode():
            noise = torch.randn((next(iter(x.values())).shape[0], self.action_dim), generator=self.generator, device=self.device)
            a, _ = self.policy.sample_action(x, noise)
        return np.clip(a.cpu().numpy(), self._action_low, self._action_high)

    def learn(self, total_timesteps: int, callback=None, log_interval: int = 4):
        t_start = time.time()
        if self._last_obs is None:
            self._last_obs = on_main(self.mesh, lambda: self.env.reset())
        episode_num = 0
        while self.num_timesteps < total_timesteps:
            actions = self._act(self._last_obs)
            actions, new_obs, rewards, dones, infos = on_main(self.mesh, lambda a=actions: (a, *self.env.step(a)))
            self.num_timesteps += self.n_envs
            rewards = self.reward_normalizer(rewards, dones)
            for info in infos:
                if "episode" in info:
                    self.ep_info_buffer.append(info["episode"])
                    episode_num += 1
            self.buffer.add(self._last_obs, actions, rewards, dones, infos)
            self._last_obs = new_obs

            if self.num_timesteps >= self.learning_starts and self.num_timesteps % self.train_freq == 0:
                self.last_metrics = self.train_steps(self.gradient_steps)
            if callback is not None and callback(self) is False:
                break
            if self.verbose and self._is_main and episode_num and episode_num % log_interval == 0 and any("episode" in i for i in infos):
                ep_rew = np.mean([e["r"] for e in self.ep_info_buffer])
                ep_suc = np.mean([e.get("s", 0.0) for e in self.ep_info_buffer])
                fps = int(self.num_timesteps / (time.time() - t_start))
                print(
                    f"[sac] steps={self.num_timesteps} fps={fps} ep_rew_mean={ep_rew:.2f} success_rate={ep_suc:.2f} "
                    + " ".join(f"{k}={v:.4f}" for k, v in self.last_metrics.items())
                )
        return self

    def predict(self, obs: dict, deterministic: bool = True) -> np.ndarray:
        """Actions for raw observations, clipped to the action bounds: the squashed mean, or a
        sample drawn with the algorithm's generator."""
        if not deterministic:
            return self._sample(obs)
        with torch.inference_mode():
            a = self.policy.predict(self._to_device(obs))
        return np.clip(a.cpu().numpy(), self._action_low, self._action_high)

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #
    def _optimizers(self) -> dict:
        return {"actor_opt": self.actor_optimizer, "critic_opt": self.critic_optimizer, "ent_opt": self.ent_optimizer,
                "mae_opt": self.mae_optimizer}

    def state_dict(self) -> dict:
        """The single-process layout (under a mesh gathered: collective, the policy's state on
        rank 0 only)."""
        return {
            "policy": gather_state(self.policy, self.mesh),
            **{k: None if opt is None else opt.state_dict() for k, opt in self._optimizers().items()},
            "reward_normalizer": self.reward_normalizer.state_dict(),
            "num_timesteps": self.num_timesteps,
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore a :meth:`state_dict` into this (architecture-compatible) model, onto its device
        (under a mesh, each rank's shares)."""
        self.policy.load_state_dict(shard_state(d["policy"], self.policy, self.mesh))
        for k, opt in self._optimizers().items():
            if opt is not None and d.get(k) is not None:
                opt.load_state_dict(d[k])
        if "reward_normalizer" in d:
            self.reward_normalizer.load_state_dict(d["reward_normalizer"])
        self.num_timesteps = int(d["num_timesteps"])

    def save(self, path: str) -> None:
        """Write the model, optimizer and normalizer state: ``path`` and ``path.vecnorm.pkl``."""
        sd = self.state_dict()
        if not self._is_main:
            return
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
