"""V-JEPA: latent prediction over two-frame tactile "video" with tube masks (counterpart of
``m3l_tpu/ssl/vjepa.py``).

A tubelet (Conv3d) context encoder, a predictor and an EMA target encoder (a frozen copy). Each
step draws tube masks (a spatial keep-set of static size extruded through time), runs the context
encoder on the gathered kept tokens (a fixed count, so no key mask), the target encoder on every
token, and the predictor on the context latents plus one mask token per target position. The loss
is |z - h|^p / p against the layer-normed target latents, averaged over the masks, plus
``reg_coeff`` times mean(relu(1 - std over patches)) of the predictions.

The masks come from :meth:`VJEPAModule.sample_masks` (a torch generator); a test replaces it to
pass in what the JAX module drew. On a mesh they are drawn for the global batch and each rank keeps
its rows; both losses are means over fixed shapes (the spread is per sample), so a rank's share is
its mean / dp.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..models.vit import VisionTransformer, VisionTransformerPredictor
from .dino import _first, _layer_norm, frozen_copy
from .ema import ema_update
from .masks import random_tube_masks
from .module import SSLModule, as_float_image
from .schedulers import linear_schedule


def _mask_to_indices(keep_mask: torch.Tensor, count: int) -> torch.Tensor:
    """(B, N) bool with exactly ``count`` True per row -> (B, count) indices of the True entries in
    ascending order (a stable argsort of ``~keep_mask``, as JAX's)."""
    order = torch.argsort((~keep_mask).to(torch.uint8), dim=-1, stable=True)
    return order[:, :count]


class VJEPAModule(SSLModule):
    def __init__(
        self,
        encoder: VisionTransformer,
        predictor: VisionTransformerPredictor,
        *,
        mask_ratio: float = 0.75,
        num_masks: int = 1,
        loss_exp: float = 1.0,
        reg_coeff: float = 0.25,
        moving_average_decay: Union[float, Tuple[float, float]] = 0.998,
        base_lr: float = 1e-4,
        weight_decay: float = 0.04,
        warmup_epochs: int = 10,
    ):
        super().__init__()
        if not encoder.is_video:
            raise ValueError("VJEPA expects a video (tubelet) encoder: num_frames > 1")
        self.context_encoder = encoder
        self.predictor = predictor
        self.target_encoder = frozen_copy(encoder)
        self.grid = tuple(encoder.patch_embed.grid)  # (T', gh, gw)
        self.mask_ratio = mask_ratio
        self.num_masks = num_masks
        self.loss_exp = loss_exp
        self.reg_coeff = reg_coeff
        self.moving_average_decay = moving_average_decay
        self.base_lr = base_lr
        self.weight_decay = weight_decay
        self.warmup_epochs = warmup_epochs
        t, gh, gw = self.grid
        spatial_keep = max(int(round(gh * gw * (1.0 - mask_ratio))), 1)
        self.n_context = spatial_keep * t
        self.n_target = (gh * gw - spatial_keep) * t
        momentum = _first(moving_average_decay)
        self._momentum_fn = lambda step: momentum

    def trainable_parameters(self) -> dict[str, nn.Parameter]:
        """Every parameter but the target encoder's."""
        return {n: p for n, p in self.named_parameters() if not n.startswith("target_encoder.")}

    def setup_schedules(self, steps_per_epoch: int, epochs: int) -> None:
        if not isinstance(self.moving_average_decay, (int, float)):
            m0, m1 = self.moving_average_decay
            self._momentum_fn = linear_schedule(m0, m1, steps_per_epoch * epochs)

    def sample_masks(self, generator: Optional[torch.Generator], batch: int) -> torch.Tensor:
        """(num_masks, B, N) bool tube keep-masks on the module's device."""
        device = self.context_encoder.norm.weight.device
        return random_tube_masks(generator, batch, self.grid, self.mask_ratio, self.num_masks, device=device)

    def forward_loss(self, x: torch.Tensor, keeps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss_jepa, loss_reg) of ``x`` (B, T, H, W, C) under the keep-masks ``keeps`` (M, B, N)."""
        with torch.no_grad():
            h_full = _layer_norm(self.target_encoder.forward_features(x)["x_norm_patchtokens"])
        loss_jepa = torch.zeros((), dtype=torch.float32, device=x.device)
        reg = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.num_masks):
            keep = keeps[i]
            ctx_idx = _mask_to_indices(keep, self.n_context)
            tgt_idx = _mask_to_indices(~keep, self.n_target)
            ctx = self.context_encoder.forward_features(x, mask_indices=ctx_idx)["x_norm_patchtokens"]
            z = self.predictor.predict(ctx, ctx_idx, tgt_idx, mask_index=i).float()
            h = torch.take_along_dim(h_full, tgt_idx[:, :, None], dim=1)
            loss_jepa = loss_jepa + torch.mean(torch.abs(z - h) ** self.loss_exp) / self.loss_exp
            pstd = torch.sqrt(z.var(dim=1, correction=0) + 1e-4)  # the spread across patches
            reg = reg + torch.mean(torch.relu(1.0 - pstd))
        return loss_jepa / self.num_masks, reg / self.num_masks

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        x = as_float_image(batch["image"])  # (B, T, H, W, C)
        keeps = self.own_rows(self.sample_masks(generator, self.global_rows(x.shape[0])), 1)
        loss_jepa, reg = (self.share(v) for v in self.forward_loss(x, keeps))
        loss = loss_jepa + self.reg_coeff * reg
        return loss, {"loss": loss, "loss_jepa": loss_jepa, "loss_reg": reg}

    @torch.no_grad()
    def on_train_batch_end(self, aux: dict, step: int) -> None:
        ema_update(self.target_encoder.parameters(), self.context_encoder.parameters(), self._momentum_fn(step))

    @torch.no_grad()
    def get_embeddings(self, x: torch.Tensor) -> torch.Tensor:
        """Layer-normed target-encoder patch tokens (B, N, D)."""
        return _layer_norm(self.target_encoder.forward_features(x)["x_norm_patchtokens"])
