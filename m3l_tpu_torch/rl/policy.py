"""Actor-critic policy over VTMAE features (counterpart of ``m3l_tpu/rl/policy.py``).

* features = VTMAE.get_embeddings (full sequence, no mask) -> a depth-1 pre-norm transformer
  -> token mean pool;
* separate pi/vf tanh MLP towers, a linear action mean with a state-independent ``log_std``,
  and a linear value head;
* diagonal Gaussian: sampling draws from an explicit ``torch.Generator``;
* the joint PPO+MAE update's ``evaluate_actions_packed_with_mae``: the policy features and the
  MAE loss share one token pipeline, for a mask the caller draws and hands in.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..models.vtmae import VTMAE
from ..nn.layers import Linear
from ..nn.transformer import Transformer
from ..ops.masking import ModalMask
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

    def mae_loss(self, x: dict, mask: ModalMask) -> torch.Tensor:
        """Representation loss on a packed batch for the given mask."""
        return self.mae.masked_loss(x, mask)

    def features_and_mae_loss(self, x: dict, mask: ModalMask):
        """Policy features and the MAE loss with one shared token pipeline (EarlyCNN or patch
        embedding + modality/positional encodings). In ``vision_only_control`` mode the
        policy's token set differs from the MAE's, so the two run separate pipelines."""
        if self.vision_only_control:
            return self.from_packed(x), self.mae_loss(x, mask)
        use_vision = "image" in x
        mae = self.mae
        image_patches, tactile_patches = mae._raw_patches(x, use_vision, True)
        tokens = mae._tokens(x, use_vision, True, image_patches, tactile_patches)
        feats = self.post(mae.encoder.transformer(tokens)).mean(dim=1)
        loss = mae.masked_loss(x, mask, use_vision=use_vision, precomputed=(tokens, image_patches, tactile_patches))
        return feats, loss


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

    @staticmethod
    def _entropy(log_std: torch.Tensor, batch: int) -> torch.Tensor:
        return (0.5 + 0.5 * _LOG_2PI + log_std).sum().expand(batch)

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

    def evaluate_actions(self, obs: dict, actions: torch.Tensor):
        """(values, log_prob, entropy) for the PPO update."""
        mean, log_std, value = self._dist_params(obs)
        return value, self._log_prob(actions, mean, log_std), self._entropy(log_std, mean.shape[0])

    def evaluate_actions_packed(self, x: dict, actions: torch.Tensor):
        mean, log_std, value = self._heads(self.features.from_packed(x))
        return value, self._log_prob(actions, mean, log_std), self._entropy(log_std, mean.shape[0])

    def evaluate_actions_packed_with_mae(self, x: dict, actions: torch.Tensor, mask: ModalMask):
        """(values, log_prob, entropy, mae_loss), the token pipeline shared between the policy
        features and the MAE loss (the joint PPO+MAE update)."""
        feats, mae_loss = self.features.features_and_mae_loss(x, mask)
        mean, log_std, value = self._heads(feats)
        return value, self._log_prob(actions, mean, log_std), self._entropy(log_std, mean.shape[0]), mae_loss

    def predict_values(self, obs: dict) -> torch.Tensor:
        return self._dist_params(obs)[2]
