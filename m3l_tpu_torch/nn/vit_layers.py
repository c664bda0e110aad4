"""DINOv2-style transformer building blocks (counterpart of ``m3l_tpu/nn/vit_layers.py``).

Attention (qkv and proj bias) on the packed attention kernel, Mlp and the fused SwiGLU FFN,
LayerScale, stochastic depth, the pre-norm Block, CrossAttention and its block, DINOHead (an
L2-normalised bottleneck and a weight-normed last layer), and the conv patch embeddings (2-D, and
3-D tubelets). Built on the mixed-precision layers of :mod:`.layers`: parameters f32, products in
the compute dtype. LayerNorm eps is 1e-6 here (1e-5 in the VTT path); GELU is the exact erf form.

``Attention`` calls :func:`.flash_attention.flash_attention_qkv`, as the JAX module does on the
TPU: the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor. ``CrossAttention`` is
plain matrix products, as the JAX einsum.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .flash_attention import flash_attention_qkv
from .layers import Conv2d, Conv3d, LayerNorm, Linear

LN_EPS = 1e-6


def _norm(dim: int, dtype) -> LayerNorm:
    return LayerNorm(dim, eps=LN_EPS, dtype=dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None, *, bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, bias, dtype=dtype)
        self.fc2 = Linear(hidden, out or dim, bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwiGLUFFN(nn.Module):
    """Fused SwiGLU FFN; hidden sized as DINOv2's SwiGLUFFNFused (2/3 of ``hidden`` rounded up to
    a multiple of 8)."""

    def __init__(self, dim: int, hidden: int, out: Optional[int] = None, *, bias: bool = True, dtype=torch.float32):
        super().__init__()
        hidden = (int(hidden * 2 / 3) + 7) // 8 * 8
        self.w12 = Linear(dim, 2 * hidden, bias, dtype=dtype)
        self.w3 = Linear(hidden, out or dim, bias, dtype=dtype)
        self.hidden = hidden

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).split(self.hidden, dim=-1)
        return self.w3(F.silu(x1) * x2)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


def drop_path(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth; rate 0 or no generator (inference) is the identity."""
    if rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return x * mask.to(x.dtype) / keep


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = True, proj_bias: bool = True, dtype=torch.float32):
        super().__init__()
        assert dim % num_heads == 0
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim**-0.5
        self.qkv = Linear(dim, dim * 3, qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, proj_bias, dtype=dtype)

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.proj(flash_attention_qkv(self.qkv(x), self.num_heads, key_mask=key_mask, scale=self.scale))


class CrossAttention(nn.Module):
    """Queries attend to a separate key/value sequence: scores in the compute dtype, softmax in
    f32 (masked keys get -1e30), probabilities cast back before A.V."""

    def __init__(self, dim: int, num_heads: int, *, qkv_bias: bool = True, proj_bias: bool = True, dtype=torch.float32):
        super().__init__()
        assert dim % num_heads == 0
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim**-0.5
        self.q = Linear(dim, dim, qkv_bias, dtype=dtype)
        self.kv = Linear(dim, dim * 2, qkv_bias, dtype=dtype)
        self.proj = Linear(dim, dim, proj_bias, dtype=dtype)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, nq, _ = q_in.shape
        nk = kv_in.shape[1]
        h, dh = self.num_heads, self.head_dim
        q = self.q(q_in).reshape(b, nq, h, dh).transpose(1, 2)
        k, v = self.kv(kv_in).reshape(b, nk, 2, h, dh).permute(2, 0, 3, 1, 4)
        scores = (torch.matmul(q, k.transpose(-1, -2)) * self.scale).float()
        if key_mask is not None:
            zero = torch.zeros((), device=scores.device)
            scores = scores + torch.where(key_mask[:, None, None, :], zero, torch.full_like(zero, -1e30))
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        return self.proj(torch.matmul(attn, v).transpose(1, 2).reshape(b, nq, h * dh))


class Block(nn.Module):
    """Pre-norm block with LayerScale and stochastic depth."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        *,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        proj_bias: bool = True,
        ffn_bias: bool = True,
        drop_path_rate: float = 0.0,
        init_values: Optional[float] = 1.0,
        ffn_layer: str = "mlp",
        dtype=torch.float32,
    ):
        super().__init__()
        self.norm1 = _norm(dim, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, proj_bias=proj_bias, dtype=dtype)
        self.ls1 = LayerScale(dim, init_values) if init_values else None
        self.norm2 = _norm(dim, dtype)
        hidden = int(dim * mlp_ratio)
        if ffn_layer == "mlp":
            self.mlp = Mlp(dim, hidden, bias=ffn_bias, dtype=dtype)
        elif ffn_layer in ("swiglu", "swiglufused"):
            self.mlp = SwiGLUFFN(dim, hidden, bias=ffn_bias, dtype=dtype)
        elif ffn_layer == "identity":
            self.mlp = nn.Identity()
        else:
            raise NotImplementedError(ffn_layer)
        self.ls2 = LayerScale(dim, init_values) if init_values else None
        self.drop_path_rate = drop_path_rate

    def forward(self, x: torch.Tensor, key_mask: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.attn(self.norm1(x), key_mask)
        if self.ls1 is not None:
            h = self.ls1(h)
        x = x + drop_path(h, self.drop_path_rate, generator)
        h = self.mlp(self.norm2(x))
        if self.ls2 is not None:
            h = self.ls2(h)
        return x + drop_path(h, self.drop_path_rate, generator)


class CrossAttentionBlock(nn.Module):
    """Pre-norm cross-attention block."""

    def __init__(self, dim: int, num_heads: int, *, mlp_ratio: float = 4.0, qkv_bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.norm_q = _norm(dim, dtype)
        self.norm_kv = _norm(dim, dtype)
        self.xattn = CrossAttention(dim, num_heads, qkv_bias=qkv_bias, dtype=dtype)
        self.norm2 = _norm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype)

    def forward(self, q: torch.Tensor, kv: torch.Tensor, key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = q + self.xattn(self.norm_q(q), self.norm_kv(kv), key_mask)
        return q + self.mlp(self.norm2(q))


class DINOHead(nn.Module):
    """MLP -> L2-normalised bottleneck -> weight-normed linear, W[o] = g[o] V[o] / |V[o]|."""

    def __init__(self, in_dim: int, out_dim: int, *, hidden_dim: int = 2048, bottleneck_dim: int = 256, nlayers: int = 3, mlp_bias: bool = True, dtype=torch.float32):
        super().__init__()
        nlayers = max(nlayers, 1)
        dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        self.mlp_layers = nn.ModuleList([Linear(dims[i], dims[i + 1], mlp_bias, dtype=dtype) for i in range(nlayers)])
        self.last_v = nn.Parameter(torch.randn(out_dim, bottleneck_dim) * 0.02)
        self.last_g = nn.Parameter(torch.ones(out_dim))
        self.out_dim = out_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.mlp_layers):
            x = layer(x)
            if i < len(self.mlp_layers) - 1:
                x = F.gelu(x, approximate="none")
        x = x.float()
        eps = 1e-6
        # sqrt(sum + eps^2) rather than max(norm, eps): the norm's gradient is finite at 0
        x = x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)
        v = self.last_v
        w = self.last_g[:, None] * v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)
        return x @ w.T


class PatchEmbed(nn.Module):
    """Conv patchifier: NHWC images in, tokens (B, gh*gw, D) out, row-major over the grid."""

    def __init__(self, img_size, patch_size: int, in_chans: int, embed_dim: int, *, dtype=torch.float32):
        super().__init__()
        img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.img_size = img_size
        self.patch_size = patch_size
        self.in_chans = in_chans
        self.grid = (img_size[0] // patch_size, img_size[1] // patch_size)
        self.num_patches = self.grid[0] * self.grid[1]
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class PatchEmbed3D(nn.Module):
    """Video tubelet patchifier: (B, T, H, W, C) in, tokens (B, t*gh*gw, D) out, row-major over
    (t, gh, gw)."""

    def __init__(self, num_frames: int, tubelet_size: int, img_size, patch_size: int, in_chans: int, embed_dim: int, *, dtype=torch.float32):
        super().__init__()
        img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.img_size = img_size
        self.patch_size = patch_size
        self.tubelet_size = tubelet_size
        self.in_chans = in_chans
        self.grid = (num_frames // tubelet_size, img_size[0] // patch_size, img_size[1] // patch_size)
        self.num_patches = self.grid[0] * self.grid[1] * self.grid[2]
        kernel = (tubelet_size, patch_size, patch_size)
        self.proj = Conv3d(in_chans, embed_dim, kernel, stride=kernel, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.permute(0, 4, 1, 2, 3)).flatten(2).transpose(1, 2)
