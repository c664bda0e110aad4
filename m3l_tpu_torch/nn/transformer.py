"""Pre-norm ViT transformer stack (counterpart of ``m3l_tpu/nn/transformer.py``).

* per block:  x = x + Attn(LN(x));  x = x + FF(LN(x))
* Attention: fused qkv projection (no bias) whose packed output goes straight into
  :func:`flash_attention_qkv` (the CUDA kernel on the card), then the output projection
  (with bias) unless heads == 1 and dim_head == dim.
* FeedForward: LN -> Linear -> GELU (exact erf) -> Linear.
* final LayerNorm on the stack output. LayerNorm eps 1e-5 throughout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .flash_attention import flash_attention_qkv
from .layers import LayerNorm, Linear


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, *, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.scale = dim_head**-0.5
        self.project_out = not (heads == 1 and dim_head == dim)
        self.norm = LayerNorm(dim, dtype=dtype)
        self.to_qkv = Linear(dim, inner * 3, bias=False, dtype=dtype)
        if self.project_out:
            self.to_out = Linear(inner, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None = None) -> torch.Tensor:
        out = flash_attention_qkv(self.to_qkv(self.norm(x)), self.heads, key_mask=key_mask, scale=self.scale)
        return self.to_out(out) if self.project_out else out


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, *, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNorm(dim, dtype=dtype)
        self.fc1 = Linear(dim, hidden_dim, dtype=dtype)
        self.fc2 = Linear(hidden_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class Transformer(nn.Module):
    """Depth-stacked pre-norm blocks with a final LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int, *, dtype=torch.float32):
        super().__init__()
        self.blocks = nn.ModuleList(
            [nn.ModuleList([Attention(dim, heads, dim_head, dtype=dtype), FeedForward(dim, mlp_dim, dtype=dtype)]) for _ in range(depth)]
        )
        self.norm = LayerNorm(dim, dtype=dtype)

    def forward(self, x: torch.Tensor, key_mask: torch.Tensor | None = None) -> torch.Tensor:
        for attn, ff in self.blocks:
            x = attn(x, key_mask) + x
            x = ff(x) + x
        return self.norm(x)
