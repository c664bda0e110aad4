"""Serving: the flagship PPO+MAE policy as an in-process action server on the card.

Counterpart of ``m3l_tpu/serve.py`` ``export_policy``: raw environment observations (uint8
image (B, fs, H, W, 3), float tactile (B, fs, 6, h, w)) go in, actions come out. ``vt_load``
packing, feature extraction and the policy heads all run on the device; the image crosses to
the device as uint8. The deterministic path serves the Gaussian mean, the stochastic path
samples from a caller's ``torch.Generator``; optional action bounds clip the result
(``PPOMAE.predict`` parity, ``m3l_tpu/rl/ppo_mae.py:436-442``). A ``torch.export`` artifact is
later work.
"""
from __future__ import annotations

import numpy as np
import torch

from .models import VTMAE, VTT, VTTConfig
from .rl import ActorCritic, MAEFeatures
from .utils.device import resolve_device


def build_policy(
    config: VTTConfig | None = None,
    *,
    action_dim: int = 3,
    decoder_depth: int = 3,
    decoder_heads: int = 4,
    early_conv_masking: bool = True,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device | None = None,
) -> ActorCritic:
    """VTT -> VTMAE -> MAEFeatures -> ActorCritic, wired as ``m3l_tpu/cli/train.py`` ``build_model``.

    ``config=None`` is the CLI's default encoder: dim 256, depth 4, 4 heads x 64, mlp 512, two
    tactile sensors, frame stack 4. The decoder has the encoder's width and the CLI's mask ratio
    0.95 (neither changes serving, which runs no decoder). Weights are drawn from torch's global
    generator on the CPU (seed it with ``torch.manual_seed``), kept float32, and moved to
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    c = config if config is not None else VTTConfig(frame_stack=4)
    mae = VTMAE(
        VTT(c, dtype=dtype),
        decoder_dim=c.dim,
        masking_ratio=0.95,
        decoder_depth=decoder_depth,
        decoder_heads=decoder_heads,
        early_conv_masking=early_conv_masking,
        dtype=dtype,
    )
    feats = MAEFeatures(mae, c.dim, frame_stack=c.frame_stack, dtype=dtype)
    return ActorCritic(feats, c.dim, action_dim, dtype=dtype).to(dev)


def random_obs(rng: np.random.Generator, batch: int, frame_stack: int = 4, image_size: int = 64, tactile_size: int = 32) -> dict:
    """Raw obs of the default encoder's env (or of one at other sizes), drawn from ``rng``: uint8
    image (B, fs, 64, 64, 3) and tactile in [-1, 1] (B, fs, 6, 32, 32) for two sensors. For timing
    and checks."""
    return {
        "image": rng.integers(0, 256, (batch, frame_stack, image_size, image_size, 3), dtype=np.uint8),
        "tactile": rng.uniform(-1, 1, (batch, frame_stack, 6, tactile_size, tactile_size)).astype(np.float32),
    }


class PolicyServer:
    """Maps raw numpy observations to numpy actions with ``policy`` on its own device."""

    def __init__(self, policy: ActorCritic, action_low=None, action_high=None):
        self.policy = policy.eval()
        self.device = policy.log_std.device
        self.bounds = None
        if action_low is not None and action_high is not None:
            self.bounds = tuple(torch.as_tensor(b, dtype=torch.float32, device=self.device) for b in (action_low, action_high))

    def to_device(self, obs: dict) -> dict:
        """Raw obs arrays -> tensors on the policy's device, dtypes unchanged (uint8 stays uint8)."""
        return {k: torch.as_tensor(np.ascontiguousarray(v)).to(self.device) for k, v in obs.items()}

    def _clip(self, actions: torch.Tensor) -> np.ndarray:
        if self.bounds is not None:
            actions = torch.clamp(actions, *self.bounds)
        return actions.cpu().numpy()

    def __call__(self, obs: dict) -> np.ndarray:
        """Deterministic actions: the Gaussian mean, clipped to the bounds."""
        with torch.inference_mode():
            mean, _, _ = self.policy._dist_params(self.to_device(obs))
            return self._clip(mean)

    def sample(self, obs: dict, generator: torch.Generator) -> np.ndarray:
        """Stochastic actions drawn with ``generator`` (on the policy's device), clipped."""
        with torch.inference_mode():
            actions, _, _ = self.policy.step(self.to_device(obs), generator)
            return self._clip(actions)
