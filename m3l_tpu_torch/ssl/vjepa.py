"""V-JEPA: latent prediction over two-frame tactile "video" with tube masks (counterpart of
``m3l_tpu/ssl/vjepa.py``), and over video clips with the published multi-block 3-D masks.

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

With ``mask_generators`` (a list of :class:`~.masks.MultiBlock3D`, or dicts of their fields) the
module trains as V-JEPA's published recipe does (``app/vjepa/train.py``): each step draws every
generator's multi-block masks on the CPU from a generator seeded by (``mask_seed``, step)
(:meth:`VJEPAModule.sample_multiblock`), so the context and target counts, which change from step
to step, are known on the host without waiting for the card; the index lists reach the card by a
copy from pinned memory that does not wait either. The target encoder runs once over every token
and its output is layer-normed in f32; then for each generator i the context encoder runs on the
gathered context and the predictor on it plus mask token i at each target. The loss is the mean
over the generators of |z - h|^p / p, plus ``reg_coeff`` times the spread term. The counters
:attr:`VJEPAModule.mask_counts` (the last step's (context, target) count of each generator) and
:attr:`VJEPAModule.mask_redraws` (clips drawn again for an empty context, over all steps) are host
integers. Spans (``utils/trace.py``): ``vjepa.masks`` (the sampler and the copies), ``vjepa.target``
(the target forward and its layer norm), ``vjepa.context`` and ``vjepa.predict`` (ident: the
generator's index).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..models.vit import VisionTransformer, VisionTransformerPredictor
from ..utils import trace
from .dino import _first, _layer_norm, frozen_copy
from .ema import ema_update
from .masks import MultiBlock3D, MultiBlockDraw, random_tube_masks, sample_multiblock_masks
from .module import SSLModule, as_float_image
from .schedulers import linear_schedule


def _mask_to_indices(keep_mask: torch.Tensor, count: int) -> torch.Tensor:
    """(B, N) bool with exactly ``count`` True per row -> (B, count) indices of the True entries in
    ascending order (a stable argsort of ``~keep_mask``, as JAX's)."""
    order = torch.argsort((~keep_mask).to(torch.uint8), dim=-1, stable=True)
    return order[:, :count]


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``; to the card from pinned memory, a copy the host does not wait for."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _latent_loss(z: torch.Tensor, h: torch.Tensor, loss_exp: float) -> tuple[torch.Tensor, torch.Tensor]:
    """mean |z - h|^p / p, and mean(relu(1 - std over patches)) of the predictions."""
    pstd = torch.sqrt(z.var(dim=1, correction=0) + 1e-4)  # the spread across patches
    return torch.mean(torch.abs(z - h) ** loss_exp) / loss_exp, torch.mean(torch.relu(1.0 - pstd))


class VJEPAModule(SSLModule):
    def __init__(
        self,
        encoder: VisionTransformer,
        predictor: VisionTransformerPredictor,
        *,
        mask_ratio: float = 0.75,
        num_masks: int = 1,
        mask_generators: Optional[Sequence[Union[MultiBlock3D, dict]]] = None,
        mask_seed: int = 0,
        loss_exp: float = 1.0,
        reg_coeff: float = 0.25,
        moving_average_decay: Union[float, Tuple[float, float]] = 0.998,
        base_lr: float = 1e-4,
        weight_decay: float = 0.04,
        warmup_epochs: int = 10,
        start_lr: float = 0.0,
        final_lr: float = 0.0,
        final_weight_decay: Optional[float] = None,
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
        self.start_lr, self.final_lr, self.final_weight_decay = start_lr, final_lr, final_weight_decay
        self.mask_generators = None
        if mask_generators is not None:
            self.mask_generators = [g if isinstance(g, MultiBlock3D) else MultiBlock3D(**g) for g in mask_generators]
            self.num_masks = len(self.mask_generators)
            if predictor.num_mask_tokens < self.num_masks:
                raise ValueError(f"{self.num_masks} mask generators need as many mask tokens; the predictor has {predictor.num_mask_tokens}")
        self.mask_seed = mask_seed
        self.mask_counts: list[tuple[int, int]] = []
        self.mask_redraws = 0
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
            terms = _latent_loss(z, h, self.loss_exp)
            loss_jepa, reg = loss_jepa + terms[0], reg + terms[1]
        return loss_jepa / self.num_masks, reg / self.num_masks

    def mask_generator(self, step: int) -> torch.Generator:
        """The CPU generator of step ``step``'s multi-block masks, seeded by (``mask_seed``, step), so
        a resumed fit draws the masks it would have drawn."""
        return torch.Generator().manual_seed((self.mask_seed * 1_000_003 + step) & ((1 << 63) - 1))

    def sample_multiblock(self, generator: Optional[torch.Generator], batch: int) -> list[MultiBlockDraw]:
        """Each generator's multi-block masks for ``batch`` clips, on the CPU."""
        return [sample_multiblock_masks(generator, batch, self.grid, g) for g in self.mask_generators]

    def multiblock_loss(self, x: torch.Tensor, step: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(loss_jepa, loss_reg) of ``x`` (B, T, H, W, C) under step ``step``'s multi-block masks."""
        with trace.span("vjepa.masks"):
            draws = self.sample_multiblock(self.mask_generator(step), self.global_rows(x.shape[0]))
            self.mask_counts = [(d.context.shape[1], d.target.shape[1]) for d in draws]
            self.mask_redraws += sum(d.redraws for d in draws)
            indices = [(_to_device(self.own_rows(d.context), x.device), _to_device(self.own_rows(d.target), x.device)) for d in draws]
        with torch.no_grad(), trace.span("vjepa.target"):
            h_full = _layer_norm(self.target_encoder.forward_features(x)["x_norm_patchtokens"].float())
        loss_jepa = torch.zeros((), dtype=torch.float32, device=x.device)
        reg = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (ctx_idx, tgt_idx) in enumerate(indices):
            with trace.span("vjepa.context", i):
                ctx = self.context_encoder.forward_features(x, mask_indices=ctx_idx)["x_norm_patchtokens"]
            with trace.span("vjepa.predict", i):
                z = self.predictor.predict(ctx, ctx_idx, tgt_idx, mask_index=i).float()
            terms = _latent_loss(z, torch.take_along_dim(h_full, tgt_idx[:, :, None], dim=1), self.loss_exp)
            loss_jepa, reg = loss_jepa + terms[0], reg + terms[1]
        return loss_jepa / self.num_masks, reg / self.num_masks

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        x = as_float_image(batch["image"])  # (B, T, H, W, C)
        if self.mask_generators is not None:
            loss_jepa, reg = (self.share(v) for v in self.multiblock_loss(x, step))
        else:
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
