"""DINO self-distillation with block masks (counterpart of ``m3l_tpu/ssl/dino.py``).

Student and teacher backbone + DINOHead pairs (the teacher a frozen copy, moved only by the EMA),
one global and several local block masks per step, the first register token's output as the CLS
token, the teacher's softmax over centered logits with an EMA center (a buffer), cross-entropy
over every (student view, teacher view) pair, a linear momentum ramp and teacher-temperature
warm-up, and an optional reconstruction probe on layer-normed teacher patch tokens.

Every view runs at full length (registers + all patches) with an attention key mask, the M masks
of one kind batched into one (M*B, ...) pass. The masks come from :meth:`DINOModule.sample_masks`
(a torch generator), and :meth:`DINOModule.forward_loss` takes them and the temperature as
arguments, so a test can pass in what the JAX module drew.
"""
from __future__ import annotations

import copy
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..models.vit import VisionTransformer
from ..nn.vit_layers import DINOHead
from ..ops.patches import patchify
from .decoders import DecoderViT
from .ema import ema_update
from .losses import dino_cross_entropy, softmax_center_teacher, update_center
from .masks import sample_block_masks, sample_block_masks_constrained
from .module import SSLModule, as_float_image
from .schedulers import linear_schedule, teacher_temp_schedule


def frozen_copy(module: nn.Module) -> nn.Module:
    """A deep copy of ``module`` whose parameters take no gradient (an EMA teacher)."""
    out = copy.deepcopy(module)
    for p in out.parameters():
        p.requires_grad_(False)
    return out


def _layer_norm(x: torch.Tensor) -> torch.Tensor:
    """Parameter-free layer norm over the last axis: population variance, eps 1e-5."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + 1e-5)


def _first(value) -> float:
    return float(value) if isinstance(value, (int, float)) else float(value[0])


class DINOModule(SSLModule):
    teacher_prefixes: tuple[str, ...] = ("teacher_backbone.", "teacher_head.")

    def __init__(
        self,
        encoder: VisionTransformer,
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
        with_reconstruction_probe: bool = True,
        base_lr: float = 1e-4,
        weight_decay: float = 0.04,
        warmup_epochs: int = 10,
        dtype=torch.float32,
    ):
        super().__init__()
        if encoder.num_register_tokens < 1:
            raise ValueError("DINO needs at least one register token: the first is the CLS token")
        self.student_backbone = encoder
        self.student_head = DINOHead(encoder.embed_dim, dino_out_dim, hidden_dim=dino_hidden_dim, bottleneck_dim=dino_bottleneck_dim, dtype=dtype)
        self.teacher_backbone = frozen_copy(encoder)
        self.teacher_head = frozen_copy(self.student_head)
        self.register_buffer("center", torch.zeros(1, dino_out_dim))

        self.patch_size = encoder.patch_size
        self.grid = tuple(encoder.patch_embed.grid)
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

        self.recon_probe = (
            DecoderViT(
                input_embed_dim=encoder.embed_dim,
                img_size=encoder.img_size,
                patch_size=encoder.patch_size,
                in_chans=encoder.in_chans,
                embed_dim=256,
                depth=2,
                num_heads=8,
                dtype=dtype,
            )
            if with_reconstruction_probe
            else None
        )
        # the schedules before setup_schedules (the Trainer calls it): the ramp's start, and the
        # temperature warm-up over one step
        momentum = _first(moving_average_decay)
        self._momentum_fn = lambda step: momentum
        self._temp_fn = teacher_temp_schedule(self._temp_arg(), 1)

    def _temp_arg(self):
        return self.teacher_temp if isinstance(self.teacher_temp, (int, float)) else tuple(self.teacher_temp)

    def trainable_parameters(self) -> dict[str, nn.Parameter]:
        """Every parameter but the teachers'."""
        return {n: p for n, p in self.named_parameters() if not n.startswith(self.teacher_prefixes)}

    def setup_schedules(self, steps_per_epoch: int, epochs: int) -> None:
        if not isinstance(self.moving_average_decay, (int, float)):
            m0, m1 = self.moving_average_decay
            self._momentum_fn = linear_schedule(m0, m1, steps_per_epoch * epochs)
        self._temp_fn = teacher_temp_schedule(self._temp_arg(), self.teacher_warmup_epochs * steps_per_epoch)

    # ------------------------------------------------------------------ #
    def sample_masks(self, generator: Optional[torch.Generator], batch: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(global (Mg, B, N), local (Ml, B, N)) bool keep-masks on the module's device: the local
        masks, then the global ones constrained away from their union (unless overlap is allowed)."""
        device = self.center.device
        local = sample_block_masks(generator, batch, self.grid, self.local_mask_scale, self.num_local_masks, device=device)
        if self.allow_mask_overlap:
            glob = sample_block_masks(generator, batch, self.grid, self.global_mask_scale, self.num_global_masks, device=device)
        else:
            forbidden = torch.any(local, dim=0)
            glob = sample_block_masks_constrained(
                generator, batch, self.grid, self.global_mask_scale, self.num_global_masks, forbidden, self.min_keep
            )
        return glob, local

    @staticmethod
    def _cls_after_head(backbone: VisionTransformer, head: DINOHead, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """The head on the first register token of every (mask, sample): (M*B, K), mask-major."""
        out = backbone.forward_features_multimask(x, masks)
        return head(out["x_norm_regtokens"][:, 0])

    def forward_loss(self, x: torch.Tensor, global_masks: torch.Tensor, local_masks: torch.Tensor, teacher_temp):
        """(loss, teacher logits (Mg*B, K)) for images ``x`` (B, H, W, C) under the given masks."""
        b = x.shape[0]
        student_global = self._cls_after_head(self.student_backbone, self.student_head, x, global_masks)
        student_local = self._cls_after_head(self.student_backbone, self.student_head, x, local_masks)
        student_views = list(student_global.reshape(self.num_global_masks, b, -1)) + list(
            student_local.reshape(self.num_local_masks, b, -1)
        )
        with torch.no_grad():
            teacher_logits = self._cls_after_head(self.teacher_backbone, self.teacher_head, x, global_masks)
            teacher_probs = softmax_center_teacher(self.center, teacher_logits, teacher_temp)
        teacher_views = list(teacher_probs.reshape(self.num_global_masks, b, -1))
        return dino_cross_entropy(student_views, teacher_views, self.student_temp), teacher_logits

    def probe_loss(self, x: torch.Tensor) -> torch.Tensor:
        """The reconstruction probe's MSE on the pixels of every patch, from the layer-normed
        teacher patch tokens of the whole image (no gradient into the teacher)."""
        with torch.no_grad():
            emb = _layer_norm(self.teacher_backbone.forward_features(x)["x_norm_patchtokens"])
        pred = self.recon_probe(emb)
        target = patchify(x, self.patch_size, self.patch_size).float()
        return torch.mean((pred.float() - target) ** 2)

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        x = as_float_image(batch["image"])
        global_masks, local_masks = self.sample_masks(generator, x.shape[0])
        temp = self._temp_fn(step)
        ssl_loss, teacher_logits = self.forward_loss(x, global_masks, local_masks, temp)
        aux = {"ssl_loss": ssl_loss, "teacher_logits": teacher_logits, "teacher_temp": torch.tensor(temp, dtype=torch.float32)}
        loss = ssl_loss
        if self.recon_probe is not None:
            aux["reconstruction_loss"] = probe = self.probe_loss(x)
            loss = loss + probe
        aux["loss"] = loss
        return loss, aux

    def ema_pairs(self) -> list[tuple[nn.Module, nn.Module]]:
        """(teacher, student) module pairs the EMA moves."""
        return [(self.teacher_backbone, self.student_backbone), (self.teacher_head, self.student_head)]

    @torch.no_grad()
    def on_train_batch_end(self, aux: dict, step: int) -> None:
        """The center's EMA (momentum 0.9), then the teachers' EMA at the scheduled momentum."""
        self.center.copy_(update_center(self.center, aux["teacher_logits"], momentum=0.9))
        self._teacher_ema(step)

    def _teacher_ema(self, step: int) -> None:
        if self.use_momentum:
            decay = self._momentum_fn(step)
            for teacher, student in self.ema_pairs():
                ema_update(teacher.parameters(), student.parameters(), decay)
