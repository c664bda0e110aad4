"""Frozen-encoder feature extractor for DINO-feature PPO (counterpart of
``m3l_tpu/rl/frozen_features.py`` ``FrozenEncoderFeatures``).

The vt_load-packed modalities become RGB crops, modality-major (``image``, then the sorted
``tactile*`` keys; each ``fs * 3`` channel stack splits into ``fs`` crops), each resized to
``crop_size`` bilinearly with ``models/vit.py`` ``resize`` (``jax.image.resize``'s weights). The
frozen encoder maps all B * n crops to their CLS features under ``torch.no_grad()`` (JAX's
``stop_gradient``): its attention launches the forward kernel only, and its parameters get no
gradient, so the policy's Adam moves them by exactly 0. A depth-1 transformer over the n crop
features and a mean pool follow.
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.vit import resize
from ..nn.transformer import Transformer
from ..utils.obs import vt_load


class FrozenEncoderFeatures(nn.Module):
    def __init__(self, encoder: nn.Module, dim: int, *, frame_stack: int = 1, crop_size: int = 70, dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.frame_stack = frame_stack
        self.crop_size = crop_size
        self.post = Transformer(dim, depth=1, heads=4, dim_head=64, mlp_dim=dim * 2, dtype=dtype)

    def _crops(self, x: dict) -> torch.Tensor:
        """(B, n_crops, S, S, 3): for each modality (image, tactile1..N) its ``fs * 3`` channel
        stack split into ``fs`` RGB crops, modality-major."""
        crops = []
        for k in ["image"] + sorted(k for k in x if k.startswith("tactile")):
            v = x[k]
            b, h, w, c = v.shape
            fs = c // 3
            v = v.reshape(b, h, w, fs, 3).permute(0, 3, 1, 2, 4)  # (B, fs, H, W, 3)
            if (h, w) != (self.crop_size, self.crop_size):
                v = resize(v, (b, fs, self.crop_size, self.crop_size, 3), "bilinear")
            crops.append(v)
        return torch.cat(crops, dim=1)

    def from_packed(self, x: dict) -> torch.Tensor:
        crops = self._crops(x)
        b, n, s = crops.shape[:3]
        with torch.no_grad():  # the frozen encoder
            feats = self.encoder(crops.reshape(b * n, s, s, 3))  # (B * n, D) CLS features
        return self.post(feats.reshape(b, n, -1)).mean(dim=1)

    def forward(self, obs: dict) -> torch.Tensor:
        return self.from_packed(vt_load(obs, frame_stack=self.frame_stack))
