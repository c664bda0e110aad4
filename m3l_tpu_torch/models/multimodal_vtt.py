"""Multimodal VTT for DINO-style training (counterpart of ``m3l_tpu/models/multimodal_vtt.py``).

Three patch-embedding towers (the image and one per tactile sensor, the same number of patches
each), one sin/cos position table over the vertically stacked ((1 + tactiles) * gh, gw) grid with
each modality on its own third, register tokens, the pre-norm ``nn/transformer.py`` trunk (the
packed attention kernel on the card) and a final eps-1e-6 LayerNorm, with the DINO
``forward_features`` dict.

Masks are boolean (B, patches_per_modality) keep-masks, tiled over the three modality segments
and enforced as one attention key mask over the whole sequence (registers always kept), so the
same positions are masked in every modality.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..nn.layers import LayerNorm
from ..nn.transformer import Transformer
from ..ops.posenc import sincos_nd
from .vtt import PatchEmbed


class MultimodalVTT(nn.Module):
    def __init__(
        self,
        *,
        image_size=(70, 70),
        tactile_size=(70, 70),
        image_patch_size: int = 14,
        tactile_patch_size: int = 14,
        dim: int = 384,
        depth: int = 4,
        heads: int = 6,
        mlp_dim: int = 768,
        dim_head: int = 64,
        image_channels: int = 3,
        tactile_channels: int = 3,
        num_tactiles: int = 2,
        frame_stack: int = 1,
        num_register_tokens: int = 1,
        dtype=torch.float32,
    ):
        super().__init__()
        ih, iw = (image_size, image_size) if isinstance(image_size, int) else image_size
        th, tw = (tactile_size, tactile_size) if isinstance(tactile_size, int) else tactile_size
        self.embed_dim = dim
        self.num_register_tokens = num_register_tokens
        self.num_tactiles = num_tactiles
        self.frame_stack = frame_stack
        self.dtype = dtype
        self.image_grid = (ih // image_patch_size, iw // image_patch_size)
        self.tactile_grid = (th // tactile_patch_size, tw // tactile_patch_size)
        n_img = self.image_grid[0] * self.image_grid[1]
        if n_img != self.tactile_grid[0] * self.tactile_grid[1]:
            raise ValueError(f"every modality needs the same number of patches: image grid {self.image_grid}, tactile grid {self.tactile_grid}")
        self.patches_per_modality = n_img
        self.num_modalities = 1 + num_tactiles
        self.num_patches = n_img * self.num_modalities
        self.mask_grid = self.image_grid  # masks are drawn on the per-modality grid

        ich = image_channels * frame_stack
        tch = tactile_channels * frame_stack
        self.image_embed = PatchEmbed(image_patch_size, image_patch_size, ich * image_patch_size**2, dim, dtype=dtype)
        self.tactile_embeds = nn.ModuleList(
            [PatchEmbed(tactile_patch_size, tactile_patch_size, tch * tactile_patch_size**2, dim, dtype=dtype) for _ in range(num_tactiles)]
        )
        gh, gw = self.image_grid
        self.register_buffer("_pos_table", torch.from_numpy(sincos_nd((self.num_modalities * gh, gw), dim)), persistent=False)
        self.register_tokens = nn.Parameter(torch.randn(1, num_register_tokens, dim) * 1e-6) if num_register_tokens else None
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-6, dtype=dtype)

    # ------------------------------------------------------------------ #
    def _embed_all(self, x: dict) -> torch.Tensor:
        """(B, 3N, D): each modality's patch tokens plus its third of the position table."""
        n = self.patches_per_modality
        pos = self._pos_table.to(self.dtype)
        parts = [self.image_embed(self.image_embed.to_patches(x["image"]).to(self.dtype)) + pos[None, :n]]
        for i, tower in enumerate(self.tactile_embeds):
            t = tower(tower.to_patches(x[f"tactile{i + 1}"]).to(self.dtype))
            parts.append(t + pos[None, (i + 1) * n : (i + 2) * n])
        return torch.cat(parts, dim=1)

    def _with_registers(self, tokens: torch.Tensor, km: Optional[torch.Tensor]):
        if self.register_tokens is not None:
            b = tokens.shape[0]
            regs = self.register_tokens.expand(b, -1, -1).to(tokens.dtype)
            tokens = torch.cat([regs, tokens], dim=1)
            if km is not None:
                km = torch.cat([torch.ones(b, self.num_register_tokens, dtype=torch.bool, device=km.device), km], dim=1)
        return tokens, km

    def _outputs(self, out: torch.Tensor, masks) -> dict:
        x_norm = self.norm(out)
        r = self.num_register_tokens
        return {"x_norm_regtokens": x_norm[:, :r], "x_norm_patchtokens": x_norm[:, r:], "x_prenorm": out, "masks": masks}

    def forward_features(self, x: dict, key_mask: Optional[torch.Tensor] = None) -> dict:
        """key_mask: (B, patches_per_modality) bool, the same positions kept in every modality."""
        km = key_mask.repeat(1, self.num_modalities) if key_mask is not None else None
        tokens, km = self._with_registers(self._embed_all(x), km)
        return self._outputs(self.transformer(tokens, km), key_mask)

    def forward_features_multimask(self, x: dict, key_masks: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        """key_masks: (M, B, patches_per_modality) bool; one batched pass, tokens tiled mask-major."""
        m, b, n = key_masks.shape
        tokens = self._embed_all(x).repeat(m, 1, 1)
        tokens, km = self._with_registers(tokens, key_masks.reshape(m * b, n).repeat(1, self.num_modalities))
        return self._outputs(self.transformer(tokens, km), key_masks)
