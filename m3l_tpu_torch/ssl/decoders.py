"""Reconstruction decoders (counterpart of ``m3l_tpu/ssl/decoders.py``).

* :class:`DecoderViT`: linear embed, + position table, blocks, norm, per-patch pixel prediction
  (the online reconstruction probe).
* :class:`MaskDecoderViT`: first scatters mask tokens back into the full sequence through
  ``ids_restore`` (the He-style MAE decoder); its blocks run the packed attention kernel.
* :class:`MaskedQueryDecoderViT`: cross-attention blocks whose queries are only the masked
  positions and whose keys and values are the visible latents (CrossMAE-style); predictions are
  scattered back to (B, N, p*p*c) with zeros at visible positions.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import LayerNorm, Linear
from ..nn.vit_layers import LN_EPS, Block, CrossAttentionBlock
from ..ops.posenc import sincos_nd


class _Decoder(nn.Module):
    """What the three decoders share: embed, position table, final norm and prediction."""

    def __init__(self, *, input_embed_dim: int, img_size, patch_size: int, in_chans: int, embed_dim: int, dtype):
        super().__init__()
        img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.embed_dim = embed_dim
        self.decoder_embed = Linear(input_embed_dim, embed_dim, dtype=dtype)
        self.register_buffer("_pos_table", torch.from_numpy(sincos_nd(self.grid, embed_dim)), persistent=False)

    def _head(self, dim: int, dtype):
        self.norm = LayerNorm(dim, eps=LN_EPS, dtype=dtype)
        self.decoder_pred = Linear(dim, self.patch_size * self.patch_size * self.in_chans, dtype=dtype)


class DecoderViT(_Decoder):
    def __init__(
        self,
        *,
        input_embed_dim: int,
        img_size=(224, 224),
        patch_size: int = 16,
        in_chans: int = 3,
        embed_dim: int = 512,
        depth: int = 8,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        dtype=torch.float32,
    ):
        super().__init__(input_embed_dim=input_embed_dim, img_size=img_size, patch_size=patch_size, in_chans=in_chans, embed_dim=embed_dim, dtype=dtype)
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, init_values=1.0, dtype=dtype) for _ in range(depth)])
        self._head(embed_dim, dtype)

    def _decode(self, tokens: torch.Tensor) -> torch.Tensor:
        x = tokens + self._pos_table[None].to(tokens.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.decoder_pred(self.norm(x))

    def forward(self, z: torch.Tensor, **_) -> torch.Tensor:
        return self._decode(self.decoder_embed(z))


class MaskDecoderViT(DecoderViT):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.mask_token = nn.Parameter(torch.randn(1, 1, self.embed_dim) * 0.02)

    def forward(self, z: torch.Tensor, ids_restore: torch.Tensor, **_) -> torch.Tensor:
        """z: (B, K, D_in) visible-token latents; ids_restore: (B, N)."""
        x = self.decoder_embed(z)
        b, k, d = x.shape
        n = ids_restore.shape[1]
        x_full = torch.cat([x, self.mask_token.to(x.dtype).expand(b, n - k, d)], dim=1)
        return self._decode(torch.take_along_dim(x_full, ids_restore[:, :, None], dim=1))


class MaskedQueryDecoderViT(_Decoder):
    """Queries: the mask token + the position of each masked patch, evolving through the blocks;
    keys and values: the embedded visible latents + their positions, fixed across blocks."""

    def __init__(
        self,
        *,
        input_embed_dim: int,
        img_size=(224, 224),
        patch_size: int = 16,
        in_chans: int = 3,
        embed_dim: int = 512,
        depth: int = 8,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        dtype=torch.float32,
    ):
        super().__init__(input_embed_dim=input_embed_dim, img_size=img_size, patch_size=patch_size, in_chans=in_chans, embed_dim=embed_dim, dtype=dtype)
        self.mask_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 0.02)
        self.blocks = nn.ModuleList([CrossAttentionBlock(embed_dim, num_heads, mlp_ratio=mlp_ratio, dtype=dtype) for _ in range(depth)])
        self._head(embed_dim, dtype)

    def forward(self, z: torch.Tensor, ids_keep: torch.Tensor, ids_masked: torch.Tensor, **_) -> torch.Tensor:
        """z: (B, K, D_in) visible latents; ids_keep: (B, K); ids_masked: (B, M). Returns
        (B, N, p*p*c) with zeros at visible positions."""
        kv = self.decoder_embed(z)
        pos = self._pos_table.to(kv.dtype)  # (N, D)
        kv = kv + pos[ids_keep]
        q = self.mask_token.to(kv.dtype) + pos[ids_masked]
        for blk in self.blocks:
            q = blk(q, kv)
        pred_m = self.decoder_pred(self.norm(q))  # (B, M, ppc)
        b = pred_m.shape[0]
        out = torch.zeros((b, pos.shape[0], pred_m.shape[-1]), dtype=pred_m.dtype, device=pred_m.device)
        return out.index_put((torch.arange(b, device=out.device)[:, None], ids_masked), pred_m)
