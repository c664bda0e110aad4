"""I-JEPA: latent prediction of masked target blocks from a context block (counterpart of
``m3l_tpu/ssl/ijepa.py``).

A context encoder and a predictor, an EMA target encoder (a frozen copy), several target block
masks plus one context block with every target cut out, and a smooth-L1 loss against the
layer-normed target latents, weighted by each target mask. The predictor runs pad-and-mask:
full-length context tokens under an attention key mask plus a full bank of mask tokens, so every
step has the same shapes whatever the blocks.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..models.vit import VisionTransformer, VisionTransformerPredictor
from .dino import _first, _layer_norm, frozen_copy
from .ema import ema_update
from .masks import sample_block_masks
from .module import SSLModule, as_float_image
from .schedulers import linear_schedule


def cut_context(ctx: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The context block ``ctx`` (B, N) minus every target block of ``targets`` (Mt, B, N); a
    sample whose context would be empty keeps every patch."""
    ctx = ctx & ~torch.any(targets, dim=0)
    return torch.where(ctx.sum(-1, keepdim=True) > 0, ctx, torch.ones_like(ctx))


class IJEPAModule(SSLModule):
    def __init__(
        self,
        encoder: VisionTransformer,
        predictor: VisionTransformerPredictor,
        *,
        target_mask_scale: Tuple[float, float] = (0.15, 0.2),
        context_mask_scale: Tuple[float, float] = (0.85, 1.0),
        num_target_masks: int = 4,
        num_context_masks: int = 1,
        moving_average_decay: Union[float, Tuple[float, float]] = 0.998,
        base_lr: float = 1e-4,
        weight_decay: float = 0.04,
        warmup_epochs: int = 10,
    ):
        super().__init__()
        self.context_encoder = encoder
        self.predictor = predictor
        self.target_encoder = frozen_copy(encoder)
        self.grid = tuple(encoder.patch_embed.grid)
        self.target_mask_scale = tuple(target_mask_scale)
        self.context_mask_scale = tuple(context_mask_scale)
        self.num_target_masks = num_target_masks
        self.num_context_masks = num_context_masks
        self.moving_average_decay = moving_average_decay
        self.base_lr = base_lr
        self.weight_decay = weight_decay
        self.warmup_epochs = warmup_epochs
        momentum = _first(moving_average_decay)
        self._momentum_fn = lambda step: momentum

    def trainable_parameters(self) -> dict[str, nn.Parameter]:
        """Every parameter but the target encoder's."""
        return {n: p for n, p in self.named_parameters() if not n.startswith("target_encoder.")}

    def setup_schedules(self, steps_per_epoch: int, epochs: int) -> None:
        if not isinstance(self.moving_average_decay, (int, float)):
            m0, m1 = self.moving_average_decay
            self._momentum_fn = linear_schedule(m0, m1, steps_per_epoch * epochs)

    def sample_masks(self, generator: Optional[torch.Generator], batch: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(context (B, N) bool keep, targets (Mt, B, N) bool) on the module's device."""
        device = self.context_encoder.norm.weight.device
        targets = sample_block_masks(generator, batch, self.grid, self.target_mask_scale, self.num_target_masks, device=device)
        ctx = sample_block_masks(generator, batch, self.grid, self.context_mask_scale, self.num_context_masks, device=device)[0]
        return cut_context(ctx, targets), targets

    def forward_loss(self, x: torch.Tensor, ctx_mask: torch.Tensor, target_masks: torch.Tensor) -> torch.Tensor:
        ctx_tokens = self.context_encoder.forward_features(x, key_mask=ctx_mask)["x_norm_patchtokens"]  # (B, N, D)
        with torch.no_grad():
            h = _layer_norm(self.target_encoder.forward_features(x)["x_norm_patchtokens"])
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.num_target_masks):
            pred = self.predictor.predict_padded(ctx_tokens, ctx_mask, mask_index=i)
            diff = pred.float() - h
            per_token = torch.where(diff.abs() < 1.0, 0.5 * diff**2, diff.abs() - 0.5).mean(-1)  # smooth L1
            w = target_masks[i].float()
            loss = loss + (per_token * w).sum() / torch.clamp(w.sum(), min=1.0)
        return loss / self.num_target_masks

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        x = as_float_image(batch["image"])
        ctx_mask, target_masks = self.sample_masks(generator, x.shape[0])
        loss = self.forward_loss(x, ctx_mask, target_masks)
        return loss, {"ssl_loss": loss, "loss": loss}

    @torch.no_grad()
    def on_train_batch_end(self, aux: dict, step: int) -> None:
        ema_update(self.target_encoder.parameters(), self.context_encoder.parameters(), self._momentum_fn(step))

    @torch.no_grad()
    def get_embeddings(self, x: torch.Tensor) -> torch.Tensor:
        """Layer-normed target-encoder patch tokens (B, N, D)."""
        return _layer_norm(self.target_encoder.forward_features(x)["x_norm_patchtokens"])
