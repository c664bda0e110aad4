"""SAC actor-critic over shared VTMAE features (counterpart of ``m3l_tpu/rl/sac_policy.py``).

SB3's SAC architecture contract, as the JAX package keeps it:

* Actor: features -> MLP[256, 256] (ReLU) -> (mu, log_std) heads; a tanh-squashed diagonal
  Gaussian, log_std clamped to [-20, 2], the tanh log-prob correction with eps 1e-6.
* Critic: two independent Q-MLPs over concat(features, action), [256, 256] ReLU, and a
  polyak-averaged target copy.
* A root-level scalar ``log_ent_coef`` parameter.

The JAX actor draws its Gaussian noise from a key; here the noise is an argument (a tensor of
the mean's shape), so a test hands in the numbers ``jax.random.normal`` drew and the algorithm
draws its own from a ``torch.Generator``. Module names follow the nnx paths
(``actor/latent/layers/0``, ``critic/qs/1/mlp/layers/0``, ``critic_target/...``,
``log_ent_coef``), so ``utils/convert.py`` ``load_jax_params`` carries a JAX
``SACActorCritic`` across as it is.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..nn.layers import Linear
from .policy import MAEFeatures

_LOG_2PI = math.log(2.0 * math.pi)
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


class _ReluMLP(nn.Module):
    def __init__(self, in_dim: int, widths: Sequence[int], *, dtype=torch.float32):
        super().__init__()
        dims = [in_dim, *widths]
        self.layers = nn.ModuleList([Linear(dims[i], dims[i + 1], dtype=dtype) for i in range(len(widths))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = torch.relu(layer(x))
        return x


class Actor(nn.Module):
    def __init__(self, feat_dim: int, action_dim: int, net_arch: Sequence[int] = (256, 256), *, dtype=torch.float32):
        super().__init__()
        self.latent = _ReluMLP(feat_dim, net_arch, dtype=dtype)
        self.mu = Linear(net_arch[-1], action_dim, dtype=dtype)
        self.log_std = Linear(net_arch[-1], action_dim, dtype=dtype)

    def dist(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean, log_std) in f32, log_std clamped to [LOG_STD_MIN, LOG_STD_MAX]."""
        h = self.latent(feats)
        mean = self.mu(h).float()
        log_std = torch.clamp(self.log_std(h).float(), LOG_STD_MIN, LOG_STD_MAX)
        return mean, log_std

    def action_log_prob(self, feats: torch.Tensor, noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The squashed action tanh(mean + std * noise) and its log-probability, for a standard
        normal ``noise`` of the mean's shape."""
        mean, log_std = self.dist(feats)
        std = torch.exp(log_std)
        u = mean + std * noise
        a = torch.tanh(u)
        logp = -0.5 * ((u - mean) ** 2 / std**2 + 2.0 * log_std + _LOG_2PI)
        logp = logp.sum(dim=-1) - torch.log(1.0 - a**2 + 1e-6).sum(dim=-1)
        return a, logp

    def deterministic_action(self, feats: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dist(feats)[0])


class QNet(nn.Module):
    def __init__(self, feat_dim: int, action_dim: int, net_arch: Sequence[int] = (256, 256), *, dtype=torch.float32):
        super().__init__()
        self.mlp = _ReluMLP(feat_dim + action_dim, net_arch, dtype=dtype)
        self.head = Linear(net_arch[-1], 1, dtype=dtype)

    def forward(self, feats: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        x = torch.cat([feats, actions.to(feats.dtype)], dim=-1)
        return self.head(self.mlp(x)).float()[:, 0]


class Critic(nn.Module):
    def __init__(self, feat_dim: int, action_dim: int, n_critics: int = 2, net_arch: Sequence[int] = (256, 256), *, dtype=torch.float32):
        super().__init__()
        self.qs = nn.ModuleList([QNet(feat_dim, action_dim, net_arch, dtype=dtype) for _ in range(n_critics)])

    def forward(self, feats: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        return torch.stack([q(feats, actions) for q in self.qs], dim=-1)  # (B, n_critics)


class SACActorCritic(nn.Module):
    """Shared-extractor SAC policy: features + actor + critic + target critic."""

    def __init__(
        self,
        features: MAEFeatures,
        feat_dim: int,
        action_dim: int,
        *,
        net_arch_pi: Sequence[int] = (256, 256),
        net_arch_qf: Sequence[int] = (256, 256),
        n_critics: int = 2,
        dtype=torch.float32,
    ):
        super().__init__()
        self.features = features
        self.actor = Actor(feat_dim, action_dim, net_arch_pi, dtype=dtype)
        self.critic = Critic(feat_dim, action_dim, n_critics, net_arch_qf, dtype=dtype)
        self.critic_target = Critic(feat_dim, action_dim, n_critics, net_arch_qf, dtype=dtype)
        self.log_ent_coef = nn.Parameter(torch.zeros(()))  # exp(0) = 1.0 init

    def sample_action(self, obs: dict, noise: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.actor.action_log_prob(self.features(obs), noise)

    def predict(self, obs: dict) -> torch.Tensor:
        return self.actor.deterministic_action(self.features(obs))
