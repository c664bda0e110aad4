"""Actor-critic policy over VTMAE features (counterpart of ``m3l_tpu/rl/policy.py``).

* features = VTMAE.get_embeddings (full sequence, no mask) -> a depth-1 pre-norm transformer
  -> token mean pool;
* separate pi/vf tanh MLP towers, a linear action mean with a state-independent ``log_std``,
  and a linear value head;
* diagonal Gaussian: sampling draws from an explicit ``torch.Generator``.

The serving slice carries the forward path; the MAE loss and ``evaluate_actions*`` come with
the training slice.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..models.vtmae import VTMAE
from ..nn.layers import Linear
from ..nn.transformer import Transformer
from ..utils.obs import vt_load

_LOG_2PI = math.log(2.0 * math.pi)


class MLP(nn.Module):
    def __init__(self, in_dim: int, widths: Sequence[int], *, dtype=torch.float32):
        super().__init__()
        dims = [in_dim, *widths]
        self.layers = nn.ModuleList([Linear(dims[i], dims[i + 1], dtype=dtype) for i in range(len(widths))])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return x


class MAEFeatures(nn.Module):
    """VTMAE embeddings -> depth-1 transformer -> mean pool."""

    def __init__(self, mae: VTMAE, dim: int, *, vision_only_control: bool = False, frame_stack: int = 1, dtype=torch.float32):
        super().__init__()
        self.mae = mae
        self.vision_only_control = vision_only_control
        self.frame_stack = frame_stack
        self.post = Transformer(dim, depth=1, heads=4, dim_head=64, mlp_dim=dim * 2, dtype=dtype)

    def forward(self, obs: dict) -> torch.Tensor:
        return self.from_packed(vt_load(obs, frame_stack=self.frame_stack))

    def from_packed(self, x: dict) -> torch.Tensor:
        """Features from an already vt_load-packed batch."""
        emb = self.mae.get_embeddings(x, use_tactile=not self.vision_only_control)
        return self.post(emb).mean(dim=1)


class ActorCritic(nn.Module):
    def __init__(
        self,
        features: MAEFeatures,
        feat_dim: int,
        action_dim: int,
        *,
        net_arch_pi: Sequence[int] = (256, 256),
        net_arch_vf: Sequence[int] = (256, 256),
        log_std_init: float = 0.0,
        dtype=torch.float32,
    ):
        super().__init__()
        self.features = features
        self.action_dim = action_dim
        self.pi_mlp = MLP(feat_dim, net_arch_pi, dtype=dtype)
        self.vf_mlp = MLP(feat_dim, net_arch_vf, dtype=dtype)
        self.action_net = Linear(net_arch_pi[-1], action_dim, dtype=dtype)
        self.value_net = Linear(net_arch_vf[-1], 1, dtype=dtype)
        self.log_std = nn.Parameter(torch.full((action_dim,), float(log_std_init)))

    # --- distribution helpers (diagonal Gaussian) --- #
    def _heads(self, feats: torch.Tensor):
        mean = self.action_net(self.pi_mlp(feats)).float()
        value = self.value_net(self.vf_mlp(feats)).float()[:, 0]
        return mean, self.log_std, value

    def _dist_params(self, obs: dict):
        return self._heads(self.features(obs))

    @staticmethod
    def _log_prob(actions: torch.Tensor, mean: torch.Tensor, log_std: torch.Tensor) -> torch.Tensor:
        var = torch.exp(2.0 * log_std)
        return (-0.5 * ((actions - mean) ** 2 / var + 2.0 * log_std + _LOG_2PI)).sum(dim=-1)

    # --- public API --- #
    def step(self, obs: dict, generator: torch.Generator | None = None, deterministic: bool = False):
        """Sample actions for rollout: (actions, values, log_prob). ``generator`` lies on the
        policy's device and is required unless ``deterministic``."""
        mean, log_std, value = self._dist_params(obs)
        if deterministic:
            actions = mean
        else:
            if generator is None:
                raise ValueError("step: sampling needs a torch.Generator on the policy's device")
            noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype, device=mean.device)
            actions = mean + torch.exp(log_std) * noise
        return actions, value, self._log_prob(actions, mean, log_std)

    def predict_values(self, obs: dict) -> torch.Tensor:
        return self._dist_params(obs)[2]
