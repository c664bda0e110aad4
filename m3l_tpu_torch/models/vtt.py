"""VTT — Vision-Tactile Transformer encoder (counterpart of ``m3l_tpu/models/vtt.py``).

Image patches plus N tactile-sensor patch grids: two patch-embedding towers
(patchify -> LayerNorm -> Linear -> LayerNorm), a learned positional table with a legacy CLS
row at index 0, and a pre-norm transformer trunk. NHWC tensors; float32 parameters with a
configurable compute dtype.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..nn.layers import LayerNorm, Linear
from ..nn.transformer import Transformer
from ..ops.patches import patchify


@dataclasses.dataclass(frozen=True)
class VTTConfig:
    image_size: tuple[int, int] = (64, 64)
    tactile_size: tuple[int, int] = (32, 32)
    image_patch_size: int = 8
    tactile_patch_size: int = 4
    dim: int = 256
    depth: int = 4
    heads: int = 4
    mlp_dim: int = 512
    dim_head: int = 64
    image_channels: int = 3
    tactile_channels: int = 3
    num_tactiles: int = 2
    frame_stack: int = 1

    @property
    def image_grid(self) -> tuple[int, int]:
        return (self.image_size[0] // self.image_patch_size, self.image_size[1] // self.image_patch_size)

    @property
    def tactile_grid(self) -> tuple[int, int]:
        return (self.tactile_size[0] // self.tactile_patch_size, self.tactile_size[1] // self.tactile_patch_size)

    @property
    def num_image_patches(self) -> int:
        gh, gw = self.image_grid
        return gh * gw

    @property
    def num_tactile_patches_per_sensor(self) -> int:
        gh, gw = self.tactile_grid
        return gh * gw

    @property
    def num_tactile_patches(self) -> int:
        return self.num_tactile_patches_per_sensor * self.num_tactiles

    @property
    def num_patches(self) -> int:
        return self.num_image_patches + self.num_tactile_patches

    @property
    def image_patch_dim(self) -> int:
        return self.image_channels * self.image_patch_size**2

    @property
    def tactile_patch_dim(self) -> int:
        return self.tactile_channels * self.tactile_patch_size**2


class PatchEmbed(nn.Module):
    """patchify -> LayerNorm(patch_dim) -> Linear(dim) -> LayerNorm(dim)."""

    def __init__(self, patch_h: int, patch_w: int, patch_dim: int, dim: int, *, dtype=torch.float32):
        super().__init__()
        self.patch_h, self.patch_w = patch_h, patch_w
        self.norm_in = LayerNorm(patch_dim, dtype=dtype)
        self.proj = Linear(patch_dim, dim, dtype=dtype)
        self.norm_out = LayerNorm(dim, dtype=dtype)

    def to_patches(self, x: torch.Tensor) -> torch.Tensor:
        return patchify(x, self.patch_h, self.patch_w)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.norm_out(self.proj(self.norm_in(patches)))


class VTT(nn.Module):
    def __init__(self, config: VTTConfig, *, dtype=torch.float32):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.image_embed = PatchEmbed(
            c.image_patch_size, c.image_patch_size, self.stacked_image_channels * c.image_patch_size**2, c.dim, dtype=dtype
        )
        self.tactile_embed = PatchEmbed(
            c.tactile_patch_size, c.tactile_patch_size, self.stacked_tactile_channels * c.tactile_patch_size**2, c.dim, dtype=dtype
        )
        # learned positional table with a legacy CLS slot at row 0 (rows 1..N are used)
        self.pos_embedding = nn.Parameter(torch.randn(1, c.num_patches + 1, c.dim))
        self.transformer = Transformer(c.dim, c.depth, c.heads, c.dim_head, c.mlp_dim, dtype=dtype)

    @property
    def stacked_image_channels(self) -> int:
        return self.config.image_channels * self.config.frame_stack

    @property
    def stacked_tactile_channels(self) -> int:
        return self.config.tactile_channels * self.config.frame_stack
