"""Patchify / unpatchify for NHWC images (counterpart of ``m3l_tpu/ops/patches.py``).

The per-patch flattening order is (row, col, channel), channel fastest, as the reference's
``Rearrange('b c (h p1) (w p2) -> b (h w) (p1 p2 c)')``.
"""
from __future__ import annotations

import torch


def patchify(x: torch.Tensor, patch_h: int, patch_w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/ph)*(W/pw), ph*pw*C), patch layout (p1 p2 c)."""
    b, h, w, c = x.shape
    gh, gw = h // patch_h, w // patch_w
    x = x.reshape(b, gh, patch_h, gw, patch_w, c).permute(0, 1, 3, 2, 4, 5)  # b gh gw p1 p2 c
    return x.reshape(b, gh * gw, patch_h * patch_w * c)


def unpatchify(p: torch.Tensor, grid_h: int, grid_w: int, patch_h: int, patch_w: int, channels: int) -> torch.Tensor:
    """Inverse of :func:`patchify`: (B, N, ph*pw*C) -> (B, H, W, C)."""
    b = p.shape[0]
    x = p.reshape(b, grid_h, grid_w, patch_h, patch_w, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid_h * patch_h, grid_w * patch_w, channels)
