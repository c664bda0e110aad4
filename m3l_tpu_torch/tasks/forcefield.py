"""Force-field estimation: dense normal and shear maps from ViT features (counterpart of
``m3l_tpu/tasks/forcefield.py``).

A DPT-style decoder: Reassemble blocks over the ViT's intermediate layers (hooks (2, 5, 8, 11)) at
scales 4, 2, 1 and 0.5, a top-down FeatureFusion pyramid, and a NormalShearHead emitting a
3-channel field (1 normal in [0, 1] + 2 shear in [-1, 1]), trained supervised or with a
photometric flow loss: the predicted shear field warps frame t to t + 1.

* Every ``jax.image.resize(..., "bilinear")`` is :func:`..models.vit.resize`: per-axis weight
  matrices of the triangle kernel, antialiased where the map shrinks (Reassemble at scale 0.5).
  ``F.interpolate`` is another function there.
* :func:`warp` is the JAX gather: each of the four corner indices clipped into the image, the
  weights taken from the unclipped coordinates (not ``F.grid_sample``).
* :func:`ssim`'s 3 x 3 mean is an explicit sum of shifted slices (see :func:`_window_mean`).
* Maps are NHWC at the module boundaries, as in the JAX package, and NCHW inside the decoder.
* A frozen encoder (``ForceFieldModule(train_encoder=False)``) runs its hooks under
  ``torch.no_grad()``: no saved activations and no backward through it.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..models.vit import resize
from ..nn.layers import Conv2d, Linear
from ..ssl.module import SSLModule
from .sl_module import load_encoder_from_checkpoint


class Reassemble(nn.Module):
    """Tokens (B, gh*gw, D) -> an NCHW map at ``scale`` times the token grid."""

    def __init__(self, embed_dim: int, out_ch: int, grid: tuple[int, int], scale: float, *, dtype=torch.float32):
        super().__init__()
        self.grid = tuple(grid)
        self.scale = scale
        self.proj = Linear(embed_dim, out_ch, dtype=dtype)
        self.conv = Conv2d(out_ch, out_ch, 3, 1, 1, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b = tokens.shape[0]
        gh, gw = self.grid
        x = self.proj(tokens).reshape(b, gh, gw, -1).permute(0, 3, 1, 2)
        th, tw = int(gh * self.scale), int(gw * self.scale)
        if (th, tw) != (gh, gw):
            x = resize(x, (b, x.shape[1], th, tw), "bilinear")
        return self.conv(x)


class ResidualConvUnit(nn.Module):
    def __init__(self, ch: int, *, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(ch, ch, 3, 1, 1, dtype=dtype)
        self.conv2 = Conv2d(ch, ch, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        h = self.conv1(F.relu(x))
        h = self.conv2(F.relu(h))
        return x + h


class FeatureFusionBlock(nn.Module):
    """Top-down fusion with residual units and a 2x bilinear upsample."""

    def __init__(self, ch: int, *, dtype=torch.float32):
        super().__init__()
        self.rcu1 = ResidualConvUnit(ch, dtype=dtype)
        self.rcu2 = ResidualConvUnit(ch, dtype=dtype)
        self.out_conv = Conv2d(ch, ch, 1, dtype=dtype)

    def forward(self, x, skip=None):
        if skip is not None:
            if skip.shape[2:] != x.shape[2:]:
                skip = resize(skip, x.shape, "bilinear")
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        b, c, h, w = x.shape
        return self.out_conv(resize(x, (b, c, h * 2, w * 2), "bilinear"))


class NormalShearHead(nn.Module):
    """convs -> NHWC (normal, sigmoid, 1 channel; shear, tanh, 2 channels) in f32."""

    def __init__(self, ch: int, *, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(ch, ch // 2, 3, 1, 1, dtype=dtype)
        self.conv2 = Conv2d(ch // 2, 32, 3, 1, 1, dtype=dtype)
        self.out = Conv2d(32, 3, 1, dtype=dtype)

    def forward(self, x):
        h = F.relu(self.conv1(x))
        h = F.relu(self.conv2(h))
        y = self.out(h).float().permute(0, 2, 3, 1)
        return torch.cat([torch.sigmoid(y[..., :1]), torch.tanh(y[..., 1:])], dim=-1)


class ForceFieldDecoder(nn.Module):
    """The encoder's hooked layers -> the (B, H, W, 3) field at the encoder's input size.
    ``frozen_encoder`` runs the encoder under ``torch.no_grad()``."""

    def __init__(self, encoder, *, hooks: Sequence[int] = (2, 5, 8, 11), fusion_ch: int = 128, dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.hooks = list(hooks)
        self.frozen_encoder = False
        grid = tuple(encoder.patch_embed.grid)
        scales = (4.0, 2.0, 1.0, 0.5)  # DPT reassemble scales
        self.reassembles = nn.ModuleList([Reassemble(encoder.embed_dim, fusion_ch, grid, s, dtype=dtype) for s in scales])
        self.fusions = nn.ModuleList([FeatureFusionBlock(fusion_ch, dtype=dtype) for _ in scales])
        self.head = NormalShearHead(fusion_ch, dtype=dtype)
        self.img_size = tuple(encoder.img_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad() if self.frozen_encoder else contextlib.nullcontext():
            layers = self.encoder.get_intermediate_layers(x, n=self.hooks, norm=True)
        maps = [re(tok) for re, tok in zip(self.reassembles, layers)]
        # top-down: start from the deepest (coarsest) map
        out = self.fusions[-1](maps[-1])
        for fuse, skip in zip(list(self.fusions[:-1])[::-1], maps[-2::-1]):
            out = fuse(out, skip)
        field = self.head(out)
        return resize(field, (x.shape[0], *self.img_size, 3), "bilinear")


# ---------------------------------------------------------------------- #
# the self-supervised photometric (flow) loss
# ---------------------------------------------------------------------- #
def _pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device), torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return ys, xs


def bilinear_gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of NHWC ``img`` at pixel coordinates ``x``, ``y`` (B, H', W'): the four
    corner indices each clipped into the image, the weights from the unclipped coordinates."""
    b, h, w, c = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = img.reshape(b, h * w, c)

    def gather(yy, xx):
        yy = torch.clamp(yy.long(), 0, h - 1)
        xx = torch.clamp(xx.long(), 0, w - 1)
        idx = (yy * w + xx).reshape(b, -1, 1)
        return torch.take_along_dim(flat, idx, dim=1).reshape(b, *yy.shape[1:], c)

    return (
        gather(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
        + gather(y0, x0 + 1) * (wx * (1 - wy))[..., None]
        + gather(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
        + gather(y0 + 1, x0 + 1) * (wx * wy)[..., None]
    )


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of (B, H, W, C) by a pixel-displacement field (B, H, W, 2)."""
    ys, xs = _pixel_grid(img.shape[1], img.shape[2], img.device)
    return bilinear_gather(img, xs[None] + flow[..., 0], ys[None] + flow[..., 1])


def _window_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of each zero-padded 3 x 3 window of NHWC ``x``: the sum of nine shifted slices over
    9, as ``reduce_window(add, "SAME") / 9``. Not ``F.avg_pool2d``: on the card its backward on this
    channels-last layout gives other gradients (30% of their norm apart from the CPU's, in f64 too)."""
    h, w = x.shape[1:3]
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    return sum(padded[:, i : i + h, j : j + w] for i in range(3) for j in range(3)) / 9.0


def ssim(a: torch.Tensor, b: torch.Tensor, c1: float = 0.01**2, c2: float = 0.03**2) -> torch.Tensor:
    """The SSIM distance map of NHWC images over zero-padded 3 x 3 mean windows."""
    pool = _window_mean

    mu_a, mu_b = pool(a), pool(b)
    var_a = pool(a * a) - mu_a**2
    var_b = pool(b * b) - mu_b**2
    cov = pool(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / ((mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
    return torch.clamp((1.0 - s) / 2.0, 0.0, 1.0)


def photometric_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.85) -> torch.Tensor:
    return torch.mean(alpha * ssim(pred, target) + (1.0 - alpha) * torch.abs(pred - target))


class ForceFieldModule(SSLModule):
    """Supervised (``batch["forcefield"]``) or self-supervised (photometric flow) force-field
    training. The decoder owns the encoder, which is frozen unless ``train_encoder``: its
    parameters stay out of the optimizer and its hooks run without autograd. Every loss is a mean
    over rows and pixels (``warp`` and ``ssim`` work pixel by pixel), so under a mesh each is this
    rank's mean over dp: its share of the global batch's."""

    def __init__(
        self,
        model_task: ForceFieldDecoder,
        *,
        shear_scale_px: float = 5.0,
        train_encoder: bool = False,
        checkpoint_encoder: Optional[str] = None,
        encoder_type: str = "mae",
        base_lr: float = 1e-4,
        weight_decay: float = 0.04,
        warmup_epochs: int = 1,
    ):
        super().__init__()
        self.model_task = model_task
        self.shear_scale_px = shear_scale_px
        self.train_encoder = train_encoder
        self.base_lr = base_lr
        self.weight_decay = weight_decay
        self.warmup_epochs = warmup_epochs
        model_task.frozen_encoder = not train_encoder
        if checkpoint_encoder is not None:
            load_encoder_from_checkpoint(model_task.encoder, checkpoint_encoder, encoder_type)

    def trainable_parameters(self) -> dict[str, nn.Parameter]:
        """Every parameter but the ViT encoder's, unless it is fine-tuned."""
        return {n: p for n, p in self.named_parameters() if self.train_encoder or not n.startswith("model_task.encoder.")}

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        x = batch["image"]  # (B, H, W, C), two stacked frames for the self-supervised loss
        field = self.model_task(x)
        if "forcefield" in batch:  # supervised
            loss = self.share(torch.mean((field - batch["forcefield"]) ** 2))
            return loss, {"loss": loss}
        c = x.shape[-1] // 2
        frame_t, frame_t1 = x[..., :c], x[..., c:]
        flow = field[..., 1:] * self.shear_scale_px
        loss = photometric_loss(warp(frame_t.float(), flow), frame_t1.float())
        # a mild smoothness prior on the field
        smooth = torch.mean(torch.abs(torch.diff(field, dim=1))) + torch.mean(torch.abs(torch.diff(field, dim=2)))
        total = self.share(loss + 0.1 * smooth)
        return total, {"loss": total, "photo_loss": self.share(loss), "smooth_loss": self.share(smooth)}

    def encode(self, x):  # the decoder consumes raw images through the encoder's hooks
        return x

    def predict(self, x):
        return self.model_task(x)
