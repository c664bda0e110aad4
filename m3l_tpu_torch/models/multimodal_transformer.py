"""Modality-factored multimodal transformer and its MAE decoder (counterpart of
``m3l_tpu/models/multimodal_transformer.py``).

Per-modality token streams (B, len_m, dim_m), a linear embedding per modality, register tokens,
sin/cos or learned positions over the concatenated sequence, and either shared
``nn/vit_layers.py`` blocks over the whole sequence (``shared_attn``) or one block per modality in
every layer, each over the registers and its own segment (the registers pass through every
modality's block in turn). Every block runs the packed attention kernel on the card. The decoder
restores each modality's mask tokens from ``ids_restore`` before the blocks.
"""
from __future__ import annotations

from typing import List, Literal, Optional, Sequence

import torch
from torch import nn

from ..nn.layers import LayerNorm, Linear
from ..nn.vit_layers import LN_EPS, Block
from ..ops.posenc import sincos_nd


class MultimodalTransformer(nn.Module):
    def __init__(
        self,
        modal_dims: Sequence[int],
        modal_lens: Sequence[int],
        embed_dim: int,
        *,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        ffn_layer: str = "mlp",
        qkv_bias: bool = True,
        init_values: Optional[float] = None,
        num_register_tokens: int = 0,
        pos_embed_fn: Literal["sinusoidal", "learned"] = "learned",
        shared_attn: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        if len(modal_dims) != len(modal_lens):
            raise ValueError(f"{len(modal_dims)} modality widths for {len(modal_lens)} modality lengths")
        self.modal_dims = list(modal_dims)
        self.modal_lens = list(modal_lens)
        self.num_modalities = len(modal_dims)
        self.embed_dim = embed_dim
        self.num_register_tokens = num_register_tokens
        self.shared_attn = shared_attn
        self.dtype = dtype
        self.embeds = nn.ModuleList([Linear(d, embed_dim, dtype=dtype) for d in modal_dims])
        self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim)) if num_register_tokens else None
        total = sum(modal_lens)
        if pos_embed_fn == "sinusoidal":
            self.register_buffer("_pos", torch.from_numpy(sincos_nd((total,), embed_dim)), persistent=False)
        else:
            self._pos = None
            self.pos_embed = nn.Parameter(nn.init.trunc_normal_(torch.empty(1, total, embed_dim), std=0.02, a=-0.04, b=0.04))
        n_per_layer = 1 if shared_attn else self.num_modalities
        self.blocks = nn.ModuleList(
            [
                nn.ModuleList(
                    [
                        Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, init_values=init_values, ffn_layer=ffn_layer, dtype=dtype)
                        for _ in range(n_per_layer)
                    ]
                )
                for _ in range(depth)
            ]
        )
        self.norm = LayerNorm(embed_dim, eps=LN_EPS, dtype=dtype)

    def _positions(self) -> torch.Tensor:
        return self._pos if self._pos is not None else self.pos_embed[0]

    def embed(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per-modality (B, len_m, dim_m) -> embedded (B, len_m, D) plus positions."""
        pos = self._positions()
        out, offset = [], 0
        for x, emb, ln in zip(xs, self.embeds, self.modal_lens):
            out.append(emb(x.to(self.dtype)) + pos[offset : offset + ln][None].to(self.dtype))
            offset += ln
        return out

    def _transcode(self, x: torch.Tensor) -> torch.Tensor:
        r = self.num_register_tokens
        for layer in self.blocks:
            if self.shared_attn:
                x = layer[0](x)
                continue
            regs, rest = x[:, :r], x[:, r:]
            parts, offset = [], 0
            for m, ln in enumerate(self.modal_lens):
                seg = layer[m](torch.cat([regs, rest[:, offset : offset + ln]], dim=1))
                parts.append(seg[:, r:])
                regs = seg[:, :r]  # the registers pass through every modality's block
                offset += ln
            x = torch.cat([regs] + parts, dim=1)
        return x

    def forward_features(self, xs: List[torch.Tensor], mask_indices: Optional[List[Optional[torch.Tensor]]] = None) -> dict:
        xs = self.embed(xs)
        if mask_indices is not None:
            xs = [torch.take_along_dim(x, idx[:, :, None], dim=1) if idx is not None else x for x, idx in zip(xs, mask_indices)]
        tokens = torch.cat(xs, dim=1)
        if self.register_tokens is not None:
            regs = self.register_tokens.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
            tokens = torch.cat([regs, tokens], dim=1)
        out = self._transcode(tokens)
        x_norm = self.norm(out)
        r = self.num_register_tokens
        return {"x_norm_regtokens": x_norm[:, :r], "x_norm_patchtokens": x_norm[:, r:], "x_prenorm": out, "masks": mask_indices}

    def forward(self, xs, mask_indices=None):
        return self.forward_features(xs, mask_indices)["x_norm_patchtokens"]


class MultimodalMAEDecoder(MultimodalTransformer):
    """Restores each modality's mask tokens before the blocks, then one output projection per
    modality."""

    def __init__(self, modal_dims, modal_lens, embed_dim, *, output_dims: Optional[Sequence[int]] = None, **kwargs):
        super().__init__(modal_dims, modal_lens, embed_dim, **kwargs)
        self.mask_tokens = nn.ParameterList([nn.Parameter(torch.randn(1, 1, d) * 0.02) for d in modal_dims])
        self.preds = nn.ModuleList([Linear(embed_dim, od, dtype=self.dtype) for od in (output_dims or modal_dims)])

    def forward(self, xs: List[torch.Tensor], ids_restore: List[torch.Tensor]) -> List[torch.Tensor]:
        """xs: per-modality visible latents (B, K_m, dim_m); ids_restore: per-modality (B, len_m)
        inverse permutations."""
        restored = []
        for x, ids, mt, ln in zip(xs, ids_restore, self.mask_tokens, self.modal_lens):
            b, k, d = x.shape
            full = torch.cat([x, mt.to(x.dtype).expand(b, ln - k, d)], dim=1)
            restored.append(torch.take_along_dim(full, ids[:, :, None], dim=1))
        out = self.forward_features(restored)["x_norm_patchtokens"]
        results, offset = [], 0
        for pred, ln in zip(self.preds, self.modal_lens):
            results.append(pred(out[:, offset : offset + ln]))
            offset += ln
        return results
