"""Attentive pooling over patch tokens (counterpart of ``m3l_tpu/tasks/attentive_pooler.py``).

Learnable query tokens cross-attend to the token sequence through one CrossAttentionBlock (or a
bare CrossAttention), optionally followed by self-attention blocks; the classifier adds a linear
head over the pooled query. The cross-attention is plain matrix products (few queries), as in
the JAX package, where it is einsum and not a kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import Linear
from ..nn.vit_layers import Block, CrossAttention, CrossAttentionBlock


class AttentivePooler(nn.Module):
    def __init__(
        self,
        *,
        num_queries: int = 1,
        embed_dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        depth: int = 1,
        qkv_bias: bool = True,
        complete_block: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        self.query_tokens = nn.Parameter(nn.init.trunc_normal_(torch.empty(1, num_queries, embed_dim), std=1.0, a=-2.0, b=2.0) * 0.02)
        self.complete_block = complete_block
        if complete_block:
            self.cross = CrossAttentionBlock(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, dtype=dtype)
        else:
            self.cross = CrossAttention(embed_dim, num_heads, qkv_bias=qkv_bias, dtype=dtype)
        self.blocks = (
            nn.ModuleList(
                [Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, init_values=None, dtype=dtype) for _ in range(depth - 1)]
            )
            if depth > 1
            else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.query_tokens.expand(x.shape[0], -1, -1).to(x.dtype)
        q = self.cross(q, x)
        if self.blocks is not None:
            for blk in self.blocks:
                q = blk(q)
        return q


class AttentiveClassifier(nn.Module):
    def __init__(
        self,
        *,
        embed_dim: int = 768,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        depth: int = 1,
        qkv_bias: bool = True,
        num_classes: int = 1000,
        complete_block: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        self.pooler = AttentivePooler(
            num_queries=1, embed_dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio, depth=depth, qkv_bias=qkv_bias,
            complete_block=complete_block, dtype=dtype,
        )
        self.linear = Linear(embed_dim, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.pooler(x)[:, 0])
