"""DINOv2-style VisionTransformer zoo (counterpart of ``m3l_tpu/models/vit.py``).

Conv patch embedding (2-D, or 3-D tubelets for multi-frame input), a sinusoidal or learned
position table (resized for off-size inputs), register tokens in place of a CLS token, pre-norm
blocks with LayerScale and stochastic depth, ``forward_features`` returning
``{x_norm_regtokens, x_norm_patchtokens, x_prenorm, masks}``, and the tiny ... giant2 factories.
Inputs are NHWC (video: (B, T, H, W, C)), as in the JAX package.

Masks come in the two static-shape forms of the JAX module: ``mask_indices`` (B, K) gathers K
tokens; ``key_mask`` (B, N) bool keeps the sequence and masks attention keys.
"""
from __future__ import annotations

from typing import Literal, Optional

import numpy as np
import torch
from torch import nn

from ..nn.layers import LayerNorm, Linear
from ..nn.vit_layers import LN_EPS, Block, PatchEmbed, PatchEmbed3D
from ..ops.posenc import sincos_nd

VIT_EMBED_DIMS = {
    "vit_tiny": 192,
    "vit_small": 384,
    "vit_base": 768,
    "vit_large": 1024,
    "vit_giant2": 1536,
}


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """The Keys cubic kernel with a = -0.5 (``jax.image.resize``'s "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    """The triangle kernel (``jax.image.resize``'s "linear") of a distance ``x`` >= 0."""
    return np.maximum(0.0, 1.0 - x)


RESIZE_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str = "bicubic") -> np.ndarray:
    """(in_size, out_size) weights of ``jax.image.resize(..., method)`` along one axis: half-pixel
    sample centres, the kernel widened by in/out when shrinking (antialiasing), each column
    normalised to sum 1, and columns sampled outside the input zeroed."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    w = RESIZE_KERNELS[method](np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps), w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize(x: torch.Tensor, shape: tuple[int, ...], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` (antialiased) for a floating ``x``: one weight matrix
    per axis whose size changes, in ``x``'s dtype."""
    for d, (m, n) in enumerate(zip(x.shape, shape)):
        if m != n:
            w = torch.from_numpy(resize_weights(m, n, method).astype(np.float32)).to(x.device, x.dtype)
            x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


class VisionTransformer(nn.Module):
    def __init__(
        self,
        *,
        img_size=(224, 224),
        patch_size: int = 16,
        num_frames: int = 1,
        tubelet_size: int = 2,
        in_chans: int = 3,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        ffn_bias: bool = True,
        proj_bias: bool = True,
        drop_path_rate: float = 0.0,
        drop_path_uniform: bool = False,
        init_values: Optional[float] = 1.0,
        pos_embed_fn: Literal["sinusoidal", "learned"] = "learned",
        ffn_layer: str = "mlp",
        num_register_tokens: int = 0,
        dtype=torch.float32,
    ):
        super().__init__()
        img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.embed_dim = self.num_features = embed_dim
        self.n_blocks = depth
        self.num_heads = num_heads
        self.num_register_tokens = num_register_tokens
        self.num_frames = num_frames
        self.tubelet_size = tubelet_size
        self.is_video = num_frames > 1
        self.pos_embed_fn = pos_embed_fn
        self.dtype = dtype

        if self.is_video:
            self.patch_embed = PatchEmbed3D(num_frames, tubelet_size, img_size, patch_size, in_chans, embed_dim, dtype=dtype)
        else:
            self.patch_embed = PatchEmbed(img_size, patch_size, in_chans, embed_dim, dtype=dtype)
        self.num_patches = self.patch_embed.num_patches

        self.register_tokens = nn.Parameter(torch.randn(1, num_register_tokens, embed_dim) * 1e-6) if num_register_tokens else None
        if pos_embed_fn == "sinusoidal":
            self.register_buffer("_pos_table", torch.from_numpy(sincos_nd(self.patch_embed.grid, embed_dim)), persistent=False)
        else:
            self.pos_embed = nn.Parameter(nn.init.trunc_normal_(torch.empty(1, self.num_patches, embed_dim), std=0.02))

        dpr = [drop_path_rate] * depth if drop_path_uniform else np.linspace(0, drop_path_rate, depth, dtype=np.float32).tolist()
        self.blocks = nn.ModuleList(
            [
                Block(
                    embed_dim,
                    num_heads,
                    mlp_ratio=mlp_ratio,
                    qkv_bias=qkv_bias,
                    proj_bias=proj_bias,
                    ffn_bias=ffn_bias,
                    drop_path_rate=dpr[i],
                    init_values=init_values,
                    ffn_layer=ffn_layer,
                    dtype=dtype,
                )
                for i in range(depth)
            ]
        )
        self.norm = LayerNorm(embed_dim, eps=LN_EPS, dtype=dtype)

    # ------------------------------------------------------------------ #
    def pos_encoding(self, x_shape) -> torch.Tensor:
        """The f32 position table (N, D) for an input of ``x_shape``: the stored one at the model's
        grid, else the sinusoidal table of the new grid or the learned one resized bicubically."""
        if self.is_video:
            _, t, h, w, _ = x_shape
            grid = (t // self.tubelet_size, h // self.patch_size, w // self.patch_size)
        else:
            _, h, w, _ = x_shape
            grid = (h // self.patch_size, w // self.patch_size)
        if grid == tuple(self.patch_embed.grid):
            return self._pos_table if self.pos_embed_fn == "sinusoidal" else self.pos_embed[0]
        if self.pos_embed_fn == "sinusoidal":
            return torch.from_numpy(sincos_nd(grid, self.embed_dim)).to(self.norm.weight.device)
        base = self.pos_embed[0].reshape(*self.patch_embed.grid, self.embed_dim).float()
        return resize(base, (*grid, self.embed_dim), "bicubic").reshape(-1, self.embed_dim)

    def _registers(self, tokens: torch.Tensor, key_mask: Optional[torch.Tensor]):
        """Prepend the register tokens (and True keys for them) where the model has any."""
        if self.register_tokens is None:
            return tokens, key_mask
        b = tokens.shape[0]
        regs = self.register_tokens.expand(b, -1, -1).to(tokens.dtype)
        tokens = torch.cat([regs, tokens], dim=1)
        if key_mask is not None:
            ones = torch.ones(b, self.num_register_tokens, dtype=torch.bool, device=key_mask.device)
            key_mask = torch.cat([ones, key_mask], dim=1)
        return tokens, key_mask

    def prepare_tokens_with_masks(self, x, mask_indices: Optional[torch.Tensor] = None, key_mask: Optional[torch.Tensor] = None):
        pos = self.pos_encoding(x.shape)
        tokens = self.patch_embed(x.to(self.dtype))
        tokens = tokens + pos[None].to(tokens.dtype)
        if mask_indices is not None:
            tokens = torch.take_along_dim(tokens, mask_indices[:, :, None], dim=1)
        return self._registers(tokens, key_mask)

    def _run_blocks(self, x, key_mask=None, generator: Optional[torch.Generator] = None):
        for blk in self.blocks:
            x = blk(x, key_mask, generator)
        return x

    def _outputs(self, out: torch.Tensor, masks) -> dict:
        x_norm = self.norm(out)
        r = self.num_register_tokens
        return {"x_norm_regtokens": x_norm[:, :r], "x_norm_patchtokens": x_norm[:, r:], "x_prenorm": out, "masks": masks}

    def forward_features(
        self,
        x,
        mask_indices: Optional[torch.Tensor] = None,
        key_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        """``generator`` draws the stochastic-depth masks (None: no drop path)."""
        tokens, km = self.prepare_tokens_with_masks(x, mask_indices, key_mask)
        out = self._run_blocks(tokens, km, generator)
        return self._outputs(out, mask_indices if mask_indices is not None else key_mask)

    def forward_features_multimask(self, x, key_masks: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        """M key masks per sample in one batched pass: ``key_masks`` (M, B, N) bool; tokens are
        embedded once and tiled to (M*B, ...), mask-major."""
        m, b, n = key_masks.shape
        pos = self.pos_encoding(x.shape)
        tokens = self.patch_embed(x.to(self.dtype)) + pos[None].to(self.dtype)
        tokens, km = self._registers(tokens.repeat(m, 1, 1), key_masks.reshape(m * b, n))
        return self._outputs(self._run_blocks(tokens, km, generator), key_masks)

    def get_intermediate_layers(self, x, n=1, reshape: bool = False, return_class_token: bool = False, norm: bool = True):
        """Outputs of the last ``n`` blocks (or of the listed block indices)."""
        tokens, _ = self.prepare_tokens_with_masks(x)
        idx = list(range(len(self.blocks) - n, len(self.blocks))) if isinstance(n, int) else list(n)
        outputs = []
        cur = tokens
        for i, blk in enumerate(self.blocks):
            cur = blk(cur)
            if i in idx:
                outputs.append(cur)
        if norm:
            outputs = [self.norm(o) for o in outputs]
        r = self.num_register_tokens
        cls = [o[:, :r] for o in outputs]
        outputs = [o[:, r:] for o in outputs]
        if reshape:
            b = x.shape[0]
            gh = x.shape[-3] // self.patch_size if not self.is_video else self.patch_embed.grid[1]
            gw = x.shape[-2] // self.patch_size if not self.is_video else self.patch_embed.grid[2]
            outputs = [o.reshape(b, gh, gw, -1).permute(0, 3, 1, 2) for o in outputs]
        if return_class_token:
            return tuple(zip(outputs, cls))
        return tuple(outputs)

    def forward(self, x, **kwargs):
        return self.forward_features(x, **kwargs)["x_norm_patchtokens"]


class VisionTransformerPredictor(VisionTransformer):
    """Narrow predictor over context tokens + mask tokens (I-JEPA style): inputs projected from
    ``input_dim`` to the predictor's width, outputs back, and a bank of ``num_mask_tokens`` learned
    mask tokens (``mask_tokens``, one (1, D) parameter each)."""

    def __init__(self, *, input_dim: int, num_mask_tokens: int = 1, zero_init_mask_tokens: bool = False, **kwargs):
        kwargs.setdefault("pos_embed_fn", "sinusoidal")
        super().__init__(**kwargs)
        self.input_dim = input_dim
        self.num_mask_tokens = num_mask_tokens
        self.input_projection = Linear(input_dim, self.embed_dim, dtype=self.dtype)
        self.output_projection = Linear(self.embed_dim, input_dim, dtype=self.dtype)

        def init():
            t = torch.zeros(1, self.embed_dim)
            return t if zero_init_mask_tokens else nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0) * 0.02

        self.mask_tokens = nn.ParameterList([nn.Parameter(init()) for _ in range(num_mask_tokens)])

    def _pos(self, b: int) -> torch.Tensor:
        """The (N, D) position table at the model's own input size."""
        if self.is_video:
            return self.pos_encoding((b, self.num_frames, *self.img_size, self.in_chans))
        return self.pos_encoding((b, *self.img_size, self.in_chans))

    def _mask_token(self, mask_index: int) -> torch.Tensor:
        return self.mask_tokens[mask_index % self.num_mask_tokens]

    def predict(self, context_tokens: torch.Tensor, context_indices: torch.Tensor, target_indices: torch.Tensor, mask_index: int = 1):
        """context_tokens: (B, Kc, input_dim) encoder latents at ``context_indices`` (B, Kc);
        returns predicted latents (B, Kt, input_dim) at ``target_indices`` (B, Kt)."""
        b, kc, _ = context_tokens.shape
        x = self.input_projection(context_tokens.to(self.dtype))
        pos = self._pos(b)
        pos_b = pos[None].expand(b, -1, -1)
        x = x + torch.take_along_dim(pos_b, context_indices[:, :, None], dim=1).to(x.dtype)
        pred = self._mask_token(mask_index)[None].expand(b, target_indices.shape[1], -1).to(x.dtype)
        pred = pred + torch.take_along_dim(pos_b, target_indices[:, :, None], dim=1).to(x.dtype)
        x = self._run_blocks(torch.cat([x, pred], dim=1))
        return self.output_projection(self.norm(x)[:, kc:])

    def predict_padded(self, context_tokens: torch.Tensor, context_mask: torch.Tensor, mask_index: int = 0):
        """Pad-and-mask form: full-length context tokens (B, N, input_dim) with a (B, N) bool
        keep-mask, followed by N mask tokens; returns predictions (B, N, input_dim) at every
        position (the caller weights its loss by its target mask). The context's masked tokens
        are masked as attention keys; the mask tokens are always visible."""
        b, n, _ = context_tokens.shape
        x = self.input_projection(context_tokens.to(self.dtype))
        pos = self._pos(b)[None].to(x.dtype)
        x = x + pos
        pred = self._mask_token(mask_index)[None].expand(b, n, -1).to(x.dtype) + pos
        km = torch.cat([context_mask, torch.ones(b, n, dtype=torch.bool, device=context_mask.device)], dim=1)
        out = self._run_blocks(torch.cat([x, pred], dim=1), km)
        return self.output_projection(self.norm(out)[:, n:])


def _factory(embed_dim, depth, num_heads):
    def make(patch_size=16, num_register_tokens=0, **kwargs):
        return VisionTransformer(
            patch_size=patch_size,
            embed_dim=embed_dim,
            depth=kwargs.pop("depth", depth),
            num_heads=num_heads,
            mlp_ratio=4.0,
            num_register_tokens=num_register_tokens,
            **kwargs,
        )

    return make


vit_tiny = _factory(192, 12, 3)
vit_small = _factory(384, 12, 6)
vit_base = _factory(768, 12, 12)
vit_large = _factory(1024, 24, 16)
vit_giant2 = _factory(1536, 40, 24)


def vit_predictor(input_dim: int, patch_size=16, num_register_tokens=0, embed_dim=384, depth=6, num_heads=12, **kwargs):
    return VisionTransformerPredictor(
        input_dim=input_dim,
        patch_size=patch_size,
        embed_dim=embed_dim,
        depth=depth,
        num_heads=num_heads,
        mlp_ratio=4.0,
        num_register_tokens=num_register_tokens,
        **kwargs,
    )
