"""Generalized Advantage Estimation on device tensors (counterpart of ``m3l_tpu/rl/gae.py``).

SB3 ``RolloutBuffer.compute_returns_and_advantage`` semantics: the step after t is terminal when
an episode starts at t + 1, and the final step bootstraps from ``last_values`` unless
``last_dones``. The JAX ``lax.scan`` in reverse becomes a reverse Python loop over T.
"""
from __future__ import annotations

import torch


def compute_gae(
    rewards: torch.Tensor,  # (T, E)
    values: torch.Tensor,  # (T, E)
    episode_starts: torch.Tensor,  # (T, E) float: 1.0 if a new episode starts at t
    last_values: torch.Tensor,  # (E,)
    last_dones: torch.Tensor,  # (E,) float: 1.0 if the env was done after the final step
    gamma: float,
    gae_lambda: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages, returns), each (T, E)."""
    advantages = torch.empty_like(values)
    last_gae = torch.zeros_like(last_values)
    next_values, next_non_terminal = last_values, 1.0 - last_dones.to(values.dtype)
    starts = episode_starts.to(values.dtype)
    for t in reversed(range(rewards.shape[0])):
        delta = rewards[t] + gamma * next_values * next_non_terminal - values[t]
        last_gae = delta + gamma * gae_lambda * next_non_terminal * last_gae
        advantages[t] = last_gae
        next_values, next_non_terminal = values[t], 1.0 - starts[t]
    return advantages, advantages + values
