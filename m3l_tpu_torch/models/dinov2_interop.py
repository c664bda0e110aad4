"""DINOv2 backbone (CLS + registers) with torch-hub checkpoint interop (counterpart of
``m3l_tpu/models/dinov2_interop.py``).

* :class:`DINOv2Backbone`: the DINOv2 layout (CLS token, 4 register tokens and the patch tokens;
  a learned position table over CLS + patches only, resized bicubically to another patch grid;
  LayerScale init 1e-5; pre-norm blocks with LayerNorm eps 1e-6) on the port's ``nn/vit_layers.py``
  ``PatchEmbed`` and ``Block``. Inputs are NHWC; ``forward`` returns the normalised CLS token.
* :func:`load_torch_dinov2_state`: a torch-hub ``dinov2_vits14_reg`` state dict into it. The port's
  parameters carry the hub's names and layouts, so the load is a strict copy.
* :class:`DINOv2LinearSegHead` and :func:`load_torch_linear_seg_head`: the mmseg-style linear
  segmentation head over the patch tokens.

Nothing is downloaded: weights come from a local ``.pth`` or stay at their seeded random init.
The position table is resized with ``models/vit.py`` ``resize``, the per-axis weights of
``jax.image.resize``; ``F.interpolate``'s bicubic kernel differs from it.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.layers import Linear
from ..nn.vit_layers import Block, PatchEmbed, _norm
from .vit import resize

# keys of the hub layout that the frozen forward never reads: DINOv2's masked-image-modelling
# token (used by its iBOT training only), and BatchNorm's step count in an mmseg head
IGNORED_BACKBONE_KEYS = ("mask_token",)
IGNORED_SEG_HEAD_KEYS = ("bn.num_batches_tracked",)


class DINOv2Backbone(nn.Module):
    def __init__(
        self,
        *,
        img_size=(518, 518),
        patch_size: int = 14,
        in_chans: int = 3,
        embed_dim: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        mlp_ratio: float = 4.0,
        num_register_tokens: int = 4,
        init_values: float = 1e-5,
        ffn_layer: str = "mlp",
        dtype=torch.float32,
    ):
        super().__init__()
        img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_register_tokens = num_register_tokens
        self.dtype = dtype
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans, embed_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim)) if num_register_tokens else None
        # learned position table over [CLS] + patches (the registers get none)
        self.pos_embed = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, 1 + self.patch_embed.num_patches, embed_dim), std=0.02, a=-0.04, b=0.04)
        )
        self.blocks = nn.ModuleList(
            [Block(embed_dim, num_heads, mlp_ratio=mlp_ratio, init_values=init_values, ffn_layer=ffn_layer, dtype=dtype) for _ in range(depth)]
        )
        self.norm = _norm(embed_dim, dtype)

    def _interp_pos(self, grid: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
        """(CLS position (1, D), patch positions (gh * gw, D)) for a patch grid, the table resized
        bicubically when the grid differs from the one it was built for."""
        pos = self.pos_embed[0]
        cls_pos, patch_pos = pos[:1], pos[1:]
        if grid == tuple(self.patch_embed.grid):
            return cls_pos, patch_pos
        base = patch_pos.reshape(*self.patch_embed.grid, self.embed_dim)
        resized = resize(base.float(), (*grid, self.embed_dim), "bicubic")
        return cls_pos, resized.reshape(-1, self.embed_dim)

    def forward_features(self, x: torch.Tensor) -> dict:
        """NHWC images -> the normalised CLS, register and patch tokens and the pre-norm sequence."""
        b, h, w, _ = x.shape
        grid = (h // self.patch_size, w // self.patch_size)
        tokens = self.patch_embed(x.to(self.dtype))
        cls_pos, patch_pos = self._interp_pos(grid)
        dt = tokens.dtype
        tokens = tokens + patch_pos[None].to(dt)
        parts = [self.cls_token.to(dt).expand(b, 1, self.embed_dim) + cls_pos[None].to(dt)]
        if self.register_tokens is not None:
            parts.append(self.register_tokens.to(dt).expand(b, self.num_register_tokens, self.embed_dim))
        seq = torch.cat(parts + [tokens], dim=1)
        for blk in self.blocks:
            seq = blk(seq)
        x_norm = self.norm(seq)
        r = self.num_register_tokens
        return {
            "x_norm_clstoken": x_norm[:, 0],
            "x_norm_regtokens": x_norm[:, 1 : 1 + r],
            "x_norm_patchtokens": x_norm[:, 1 + r :],
            "x_prenorm": seq,
        }

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The CLS feature, as torch-hub DINOv2's ``forward`` returns it."""
        return self.forward_features(x)["x_norm_clstoken"]


def dinov2_vits14(num_register_tokens: int = 4, img_size=(518, 518), **kw) -> DINOv2Backbone:
    kw.setdefault("depth", 12)
    return DINOv2Backbone(img_size=img_size, patch_size=14, embed_dim=384, num_heads=6, num_register_tokens=num_register_tokens, **kw)


def _as_tensor(v) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


@torch.no_grad()
def _strict_copy(module: nn.Module, sd: dict, ignored: tuple[str, ...], what: str) -> int:
    """Copy every entry of ``sd`` into the parameter of the same name; raise on a key that names
    none (other than ``ignored``), on a shape that differs and on a parameter left unset. Returns
    the number of values loaded."""
    params = dict(module.named_parameters())
    unused = sorted(k for k in sd if k not in params and k not in ignored)
    missing = sorted(set(params) - set(sd))
    if unused or missing:
        raise KeyError(f"{what}: keys left unused {unused}; parameters left unset {missing}")
    loaded = 0
    for name, p in params.items():
        value = _as_tensor(sd[name])
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"{what}: {name} has shape {tuple(value.shape)}, the module {tuple(p.shape)}")
        p.copy_(value.to(p.dtype))
        loaded += value.numel()
    return loaded


def load_torch_dinov2_state(model: DINOv2Backbone, state_dict: dict) -> int:
    """Copy a torch DINOv2 state dict (tensors or numpy arrays; a leading ``backbone.`` is
    stripped) into ``model``, in place on its device. Every key is used (``mask_token``, which
    the forward never reads, is the one exception) and every parameter set, else it raises.
    Returns the number of values loaded."""
    sd = {k.removeprefix("backbone."): v for k, v in state_dict.items()}
    return _strict_copy(model, sd, IGNORED_BACKBONE_KEYS, "load_torch_dinov2_state")


class DINOv2LinearSegHead(nn.Module):
    """mmseg-style linear segmentation head over DINOv2 patch tokens: a BatchNorm over the
    feature dim on its frozen statistics, then a 1x1 convolution (a Linear here) to the class
    logits, the layout of the reference's ``dinov2_vits14_*_linear_head.pth`` assets."""

    def __init__(self, embed_dim: int = 384, num_classes: int = 150, *, dtype=torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_classes = num_classes
        self.bn_scale = nn.Parameter(torch.ones(embed_dim))
        self.bn_bias = nn.Parameter(torch.zeros(embed_dim))
        self.bn_mean = nn.Parameter(torch.zeros(embed_dim))
        self.bn_var = nn.Parameter(torch.ones(embed_dim))
        self.conv_seg = Linear(embed_dim, num_classes, dtype=dtype)

    def forward(self, patch_tokens: torch.Tensor, grid: tuple[int, int] | None = None) -> torch.Tensor:
        """(B, N, D) patch tokens -> (B, N, classes) logits, or (B, gh, gw, classes) with ``grid``."""
        x = patch_tokens.float()
        x = (x - self.bn_mean) / torch.sqrt(self.bn_var + 1e-5)
        logits = self.conv_seg(x * self.bn_scale + self.bn_bias)
        if grid is not None:
            return logits.reshape(logits.shape[0], *grid, self.num_classes)
        return logits


def load_torch_linear_seg_head(head: DINOv2LinearSegHead, checkpoint: dict) -> int:
    """Load an mmseg linear-head checkpoint (``{'state_dict': ...}`` or a bare state dict; a
    leading ``decode_head.`` is stripped) into ``head``. Every key is used (but BatchNorm's
    step count) and every parameter set, else it raises. Returns the number of values loaded."""
    sd = checkpoint.get("state_dict", checkpoint)
    sd = {k.removeprefix("decode_head."): v for k, v in sd.items()}
    names = {"bn.weight": "bn_scale", "bn.bias": "bn_bias", "bn.running_mean": "bn_mean", "bn.running_var": "bn_var",
             "conv_seg.bias": "conv_seg.bias"}
    mapped = {names.get(k, k): v for k, v in sd.items()}
    if "conv_seg.weight" in mapped:  # (classes, D, 1, 1) 1x1 convolution -> (classes, D) Linear weight
        mapped["conv_seg.weight"] = _as_tensor(mapped["conv_seg.weight"])[:, :, 0, 0]
    return _strict_copy(head, mapped, IGNORED_SEG_HEAD_KEYS, "load_torch_linear_seg_head")


def load_dinov2_checkpoint(model: DINOv2Backbone, path: str) -> int:
    """Load a local torch ``.pth`` into ``model``: a bare state dict, or one under ``model`` or
    ``state_dict``. Returns the number of values loaded. Nothing is downloaded."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_torch_dinov2_state(model, sd.get("model", sd.get("state_dict", sd)))
