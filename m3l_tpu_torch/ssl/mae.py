"""He-style MAE over single (channel-concatenated) tactile images (counterpart of
``m3l_tpu/ssl/mae.py``).

Random masking by the argsort of uniform noise (ids_keep, binary mask, ids_restore), the encoder
on the visible tokens, a decoder (He-style restore or masked queries), and the masked MSE with
optional per-patch pixel normalisation; AdamW betas (0.9, 0.95) with the weight-decay split and
the warm-up-cosine lr. The noise comes from :meth:`MAEModule.sample_noise` (a torch generator),
which a test replaces to inject the JAX noise.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.vit import VisionTransformer
from ..ops.patches import patchify, unpatchify
from .decoders import MaskDecoderViT, MaskedQueryDecoderViT
from .module import SSLModule, as_float_image


class MAEModule(SSLModule):
    def __init__(
        self,
        encoder: VisionTransformer,
        *,
        decoder_embed_dim: int = 512,
        decoder_depth: int = 8,
        decoder_num_heads: int = 16,
        mask_ratio: float = 0.75,
        norm_pix_loss: bool = True,
        decode_masked_only: bool = False,
        base_lr: float = 1e-4,
        weight_decay: float = 0.04,
        warmup_epochs: int = 10,
        dtype=torch.float32,
    ):
        super().__init__()
        self.encoder = encoder
        self.mask_ratio = mask_ratio
        self.norm_pix_loss = norm_pix_loss
        self.decode_masked_only = decode_masked_only
        self.base_lr = base_lr
        self.weight_decay = weight_decay
        self.warmup_epochs = warmup_epochs
        self.betas = (0.9, 0.95)
        self.patch_size = encoder.patch_size
        self.num_patches = encoder.num_patches
        decoder_cls = MaskedQueryDecoderViT if decode_masked_only else MaskDecoderViT
        self.decoder = decoder_cls(
            input_embed_dim=encoder.embed_dim,
            img_size=encoder.img_size,
            patch_size=encoder.patch_size,
            in_chans=encoder.in_chans,
            embed_dim=decoder_embed_dim,
            depth=decoder_depth,
            num_heads=decoder_num_heads,
            dtype=dtype,
        )

    def sample_noise(self, batch: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """(batch, num_patches) uniform noise on the module's device; ranks order the patches.
        Under a mesh ``batch`` is this rank's: the draw is the global batch's, sliced."""
        noise = torch.rand((self.global_rows(batch), self.num_patches), generator=generator, device=self.decoder.mask_token.device)
        return self.own_rows(noise)

    def random_masking(self, noise: torch.Tensor):
        """(ids_keep, mask, ids_restore) from ``noise`` (B, N): the patches of the smallest
        ``int(N * (1 - mask_ratio))`` noise values are kept (a stable sort, as jnp.argsort);
        mask is 1 at the others."""
        b, n = noise.shape
        len_keep = int(n * (1.0 - self.mask_ratio))
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        ids_keep = ids_shuffle[:, :len_keep]
        mask = torch.ones((b, n), device=noise.device)
        mask[:, :len_keep] = 0.0
        return ids_keep, torch.take_along_dim(mask, ids_restore, dim=1), ids_restore

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """x: (B, H, W, C). Returns (pred_patches, mask)."""
        ids_keep, mask, ids_restore = self.random_masking(self.sample_noise(x.shape[0], generator))
        out = self.encoder.forward_features(x, mask_indices=ids_keep)
        # registers (if any) are dropped: the decoder restores patch positions only
        latent = out["x_norm_patchtokens"]
        if self.decode_masked_only:
            ids_masked = torch.argsort(ids_restore, dim=1, stable=True)[:, ids_keep.shape[1] :]
            pred = self.decoder(latent, ids_keep, ids_masked)
        else:
            pred = self.decoder(latent, ids_restore)
        return pred, mask

    def _target(self, imgs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """f32 patches of ``imgs`` and their per-patch mean and std (variance with ddof 0)."""
        target = patchify(imgs, self.patch_size, self.patch_size).float()
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, correction=0)
        return target, mean, (var + 1.0e-6) ** 0.5

    def compute_loss(self, imgs: torch.Tensor, pred: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        target, mean, std = self._target(imgs)
        if self.norm_pix_loss:
            target = (target - mean) / std
        loss = torch.mean((pred.float() - target) ** 2, dim=-1)  # (B, N)
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        x = as_float_image(batch["image"])
        pred, mask = self(x, generator)
        # every row masks as many patches, so the masked mean over this rank's rows is its share
        loss = self.share(self.compute_loss(x, pred, mask))
        return loss, {"loss": loss}

    @torch.no_grad()
    def reconstruction_images(self, batch: dict, generator: Optional[torch.Generator], max_images: int = 8) -> dict:
        """{original, masked, reconstruction} as (H, B*W, 3) strips for image logging; only the
        first 3 channels of multi-frame inputs are shown."""
        x = as_float_image(batch["image"][:max_images])
        p = self.patch_size
        gh, gw = x.shape[1] // p, x.shape[2] // p
        pred, mask = self(x, generator)
        target, mean, std = self._target(x)
        pred = pred.float()
        if self.norm_pix_loss:
            pred = pred * std + mean  # undo the target normalisation for display
        m = mask[..., None] > 0
        recon = torch.where(m, pred, target)
        masked = torch.where(m, torch.full_like(target, 0.5), target)
        c = x.shape[-1]

        def strip(patches):
            img = unpatchify(patches, gh, gw, p, p, c)
            img = img[..., :3] if c >= 3 else img[..., :1].repeat(1, 1, 1, 3)
            return torch.cat(list(img), dim=1)  # (H, B*W, 3)

        return {"original": strip(target), "masked": strip(masked), "reconstruction": strip(recon)}
