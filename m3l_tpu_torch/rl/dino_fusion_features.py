"""MAE features fused with a frozen DINO feature (counterpart of
``m3l_tpu/rl/dino_fusion_features.py`` ``DinoCatMAEFeatures``).

The MAE embeddings go through a depth-1 transformer and a mean pool, and are concatenated with
the frozen DINO CLS feature of the middle stacked frame (channels ``3 * mid - 3 : 3 * mid``,
``mid = max(fs // 2, 1)``; resized to ``dino_crop`` bilinearly only if its size differs); a
3-layer ReLU MLP fuses the two. The DINO encoder runs under ``torch.no_grad()`` (JAX's
``stop_gradient``): forward launches only, and no gradient reaches its parameters.

* ``tactile_only_mae``: the MAE sees the tactile maps only, in the policy's embeddings and in
  its loss (the reference's ``train_dino_tac_mae.py`` variant);
* ``vision_only_control``: the policy's embeddings leave out the tactile tokens;
* :meth:`weighted_pooling`: the learnable-query pooling, off the default path as upstream.

There is no shared token pipeline (``features_and_mae_loss``): the joint update runs
:meth:`from_packed` and :meth:`mae_loss` apart, as the JAX policy falls back to.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..models.vit import resize
from ..models.vtmae import VTMAE
from ..nn.layers import Linear
from ..nn.transformer import Transformer
from ..ops.masking import ModalMask
from ..utils.obs import vt_load


class DinoCatMAEFeatures(nn.Module):
    def __init__(
        self,
        mae: VTMAE,
        dino_encoder: nn.Module,
        dim: int,
        *,
        dino_dim: int = 384,
        vision_only_control: bool = False,
        tactile_only_mae: bool = False,
        frame_stack: int = 1,
        dino_crop: int = 70,
        dtype=torch.float32,
    ):
        super().__init__()
        self.mae = mae
        self.dino_encoder = dino_encoder
        self.dim = dim
        self.vision_only_control = vision_only_control
        self.tactile_only_mae = tactile_only_mae
        self.frame_stack = frame_stack
        self.dino_crop = dino_crop
        self.post = Transformer(dim, depth=1, heads=4, dim_head=64, mlp_dim=dim * 2, dtype=dtype)
        fused = dim + dino_dim
        self.mlp1 = Linear(fused, fused, dtype=dtype)
        self.mlp2 = Linear(fused, fused, dtype=dtype)
        self.mlp3 = Linear(fused, dim, dtype=dtype)
        # learnable-query pooling (off the default path)
        self.query = nn.Parameter(torch.randn(1, 1, dim))
        self.query_projection = Linear(dim, dim, dtype=dtype)
        self.key_projection = Linear(dim, dim, dtype=dtype)

    def weighted_pooling(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, N, dim) -> (B, dim): one learned query's softmax (f32) over projected keys, applied
        to the tokens."""
        q = self.query_projection(self.query.expand(tokens.shape[0], 1, self.dim).to(tokens.dtype))
        k = self.key_projection(tokens)
        scores = torch.einsum("bqd,bnd->bqn", q, k) / math.sqrt(self.dim)
        w = torch.softmax(scores.float(), dim=-1).to(tokens.dtype)
        return torch.einsum("bqn,bnd->bqd", w, tokens)[:, 0]

    def _mae_inputs(self, x: dict) -> dict:
        return {k: v for k, v in x.items() if not (self.tactile_only_mae and k == "image")}

    def mae_modalities(self, obs_keys) -> tuple[bool, bool]:
        """(use_vision, use_tactile) of the MAE loss on a batch with these observation keys."""
        return "image" in obs_keys and not self.tactile_only_mae, True

    def from_packed(self, x: dict) -> torch.Tensor:
        emb = self.mae.get_embeddings(self._mae_inputs(x), use_tactile=not self.vision_only_control)
        z = self.post(emb).mean(dim=1)
        # the frozen DINO CLS of the middle stacked frame
        mid = max(self.frame_stack // 2, 1)
        crop = x["image"][..., 3 * mid - 3 : 3 * mid]
        if crop.shape[1] != self.dino_crop:
            crop = resize(crop, (crop.shape[0], self.dino_crop, self.dino_crop, 3), "bilinear")
        with torch.no_grad():
            dino_feat = self.dino_encoder(crop)
        h = F.relu(self.mlp1(torch.cat([z, dino_feat.to(z.dtype)], dim=-1)))
        return self.mlp3(F.relu(self.mlp2(h)))

    def mae_loss(self, x: dict, mask: ModalMask) -> torch.Tensor:
        """The MAE's masked-reconstruction loss for ``mask``, without the image under
        ``tactile_only_mae``."""
        return self.mae.masked_loss(self._mae_inputs(x), mask)

    def forward(self, obs: dict) -> torch.Tensor:
        return self.from_packed(vt_load(obs, frame_stack=self.frame_stack))
