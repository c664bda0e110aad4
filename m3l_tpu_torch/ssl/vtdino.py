"""VTDINO: DINO self-distillation over the multimodal VTT (counterpart of ``m3l_tpu/ssl/vtdino.py``).

Teacher and student :class:`..models.multimodal_vtt.MultimodalVTT` + DINOHead pairs, block masks
drawn on the per-modality patch grid and applied at the same positions in every modality, the
register token as CLS, the EMA teacher with its momentum ramp, the teacher-temperature warm-up,
the weight-decay split and an optional reconstruction probe, which reconstructs the image modality
from the teacher's image patch tokens.

The module does not run :class:`.dino.DINOModule`'s constructor (another backbone wiring) but
builds the same state: the heads, the frozen teacher copies and the ``center`` buffer. The DINO
loss, the mask sampling, the schedules, the post-update hook and the mesh (the masks drawn for the
global batch, the loss as this rank's share, the center's global mean) are DINOModule's.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..models.multimodal_vtt import MultimodalVTT
from ..nn.vit_layers import DINOHead
from ..ops.patches import patchify
from .decoders import DecoderViT
from .dino import DINOModule, _first, _layer_norm, frozen_copy
from .module import SSLModule
from .schedulers import teacher_temp_schedule


class VTDINOModule(DINOModule):
    def __init__(
        self,
        encoder: MultimodalVTT,
        *,
        dino_out_dim: int = 65536,
        dino_hidden_dim: int = 2048,
        dino_bottleneck_dim: int = 256,
        local_mask_scale: Tuple[float, float] = (0.2, 0.8),
        global_mask_scale: Tuple[float, float] = (0.2, 0.8),
        num_global_masks: int = 1,
        num_local_masks: int = 4,
        min_keep_num_sensors: int = 4,
        allow_mask_overlap: bool = False,
        moving_average_decay: Union[float, Tuple[float, float]] = 0.99,
        teacher_temp: Union[float, Tuple[float, float]] = (0.04, 0.07),
        teacher_warmup_epochs: int = 10,
        student_temp: float = 0.1,
        use_momentum: bool = True,
        with_reconstruction_probe: bool = False,
        base_lr: float = 1e-4,
        weight_decay: float = 0.04,
        warmup_epochs: int = 10,
        dtype=torch.float32,
    ):
        SSLModule.__init__(self)
        if encoder.num_register_tokens < 1:
            raise ValueError("VTDINO needs at least one register token: the first is the CLS token")
        self.student_backbone = encoder
        self.student_head = DINOHead(encoder.embed_dim, dino_out_dim, hidden_dim=dino_hidden_dim, bottleneck_dim=dino_bottleneck_dim, dtype=dtype)
        self.teacher_backbone = frozen_copy(encoder)
        self.teacher_head = frozen_copy(self.student_head)
        self.register_buffer("center", torch.zeros(1, dino_out_dim))
        self.grid = tuple(encoder.mask_grid)
        self.patch_size = encoder.image_embed.patch_h
        self.local_mask_scale = tuple(local_mask_scale)
        self.global_mask_scale = tuple(global_mask_scale)
        self.num_global_masks = num_global_masks
        self.num_local_masks = num_local_masks
        self.min_keep = min_keep_num_sensors
        self.allow_mask_overlap = allow_mask_overlap
        self.student_temp = student_temp
        self.use_momentum = use_momentum
        self.moving_average_decay = moving_average_decay
        self.teacher_temp = teacher_temp
        self.teacher_warmup_epochs = teacher_warmup_epochs
        self.base_lr = base_lr
        self.weight_decay = weight_decay
        self.warmup_epochs = warmup_epochs
        gh, gw = encoder.image_grid
        self.recon_probe = (
            DecoderViT(
                input_embed_dim=encoder.embed_dim,
                img_size=(gh * self.patch_size, gw * self.patch_size),
                patch_size=self.patch_size,
                in_chans=encoder.frame_stack * 3,
                embed_dim=256,
                depth=2,
                num_heads=8,
                dtype=dtype,
            )
            if with_reconstruction_probe
            else None
        )
        momentum = _first(moving_average_decay)
        self._momentum_fn = lambda step: momentum
        self._temp_fn = teacher_temp_schedule(self._temp_arg(), 1)

    def probe_loss(self, x: dict) -> torch.Tensor:
        """The reconstruction probe's MSE on the image's patches, from the layer-normed teacher
        tokens of the image modality (no gradient into the teacher)."""
        with torch.no_grad():
            tokens = self.teacher_backbone.forward_features(x)["x_norm_patchtokens"][:, : self.student_backbone.patches_per_modality]
            emb = _layer_norm(tokens)
        pred = self.recon_probe(emb)
        target = patchify(x["image"], self.patch_size, self.patch_size).float()
        return torch.mean((pred.float() - target) ** 2)

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        # under a mesh the Trainer has already cut every modality to this rank's rows
        x = {k: v for k, v in batch.items() if k == "image" or k.startswith("tactile")}
        return self._distill_loss(x, x["image"], generator, step)
