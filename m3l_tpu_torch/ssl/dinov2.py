"""DINOv2 = DINO CLS distillation + iBOT patch distillation + KoLeo (counterpart of
``m3l_tpu/ssl/dinov2.py``).

Two global views whose teacher views are swapped (crop A distills to crop B), teacher
normalisation by centering or Sinkhorn-Knopp (over the kept patch tokens only), an optional
separate iBOT head, the all-pairs iBOT loss over every patch position weighted by the teacher
view's keep mask (static shapes, no gather), KoLeo on the pre-head CLS tokens of each global
view, and the masked patch-center update.

On a mesh each term is this rank's share of the global batch's: the CLS cross-entropy over its
rows / dp, iBOT over the global kept counts, KoLeo with neighbours from the whole global view;
Sinkhorn-Knopp and both centers take their sums over the dp group.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.vit import VisionTransformer
from ..nn.vit_layers import DINOHead
from .dino import DINOModule, frozen_copy
from .losses import (
    dino_cross_entropy,
    ibot_patch_loss_all_pairs,
    koleo_loss,
    sinkhorn_knopp_teacher,
    softmax_center_teacher,
    update_center,
)
from .module import as_float_image


class DINOv2Module(DINOModule):
    teacher_prefixes = ("teacher_backbone.", "teacher_head.", "teacher_ibot_head.")

    def __init__(
        self,
        encoder: VisionTransformer,
        *,
        ibot_separate_head: bool = False,
        ibot_out_dim: Optional[int] = None,
        koleo_weight: float = 0.1,
        centering: str = "centering",  # or "sinkhorn_knopp"
        num_global_masks: int = 2,
        dino_out_dim: int = 65536,
        dtype=torch.float32,
        **kwargs,
    ):
        if centering not in ("centering", "sinkhorn_knopp"):
            raise NotImplementedError(centering)
        super().__init__(encoder, num_global_masks=num_global_masks, dino_out_dim=dino_out_dim, dtype=dtype, **kwargs)
        self.koleo_weight = koleo_weight
        self.centering = centering
        self.ibot_separate_head = ibot_separate_head
        ibot_dim = ibot_out_dim or dino_out_dim
        if ibot_separate_head:
            self.student_ibot_head = DINOHead(encoder.embed_dim, ibot_dim, dtype=dtype)
            self.teacher_ibot_head = frozen_copy(self.student_ibot_head)
        self.register_buffer("ibot_center", torch.zeros(1, 1, ibot_dim))

    def _ibot_heads(self) -> tuple[DINOHead, DINOHead]:
        if self.ibot_separate_head:
            return self.student_ibot_head, self.teacher_ibot_head
        return self.student_head, self.teacher_head

    def forward_loss(self, x: torch.Tensor, global_masks: torch.Tensor, local_masks: torch.Tensor, teacher_temp):
        """(loss, aux) for images ``x`` under the given masks; aux holds the three terms, the
        teacher's CLS and patch logits and the global keep masks (Mg*B, N)."""
        b = x.shape[0]
        mg, ml = self.num_global_masks, self.num_local_masks
        s_ibot_head, t_ibot_head = self._ibot_heads()

        student_global = self.student_backbone.forward_features_multimask(x, global_masks)
        student_local = self.student_backbone.forward_features_multimask(x, local_masks)
        s_cls_g = self.student_head(student_global["x_norm_regtokens"][:, 0])  # (Mg*B, K)
        s_cls_l = self.student_head(student_local["x_norm_regtokens"][:, 0])  # (Ml*B, K)
        student_views = list(s_cls_g.reshape(mg, b, -1)) + list(s_cls_l.reshape(ml, b, -1))
        s_patch = s_ibot_head(student_global["x_norm_patchtokens"])  # (Mg*B, N, Ki)

        keep = global_masks.reshape(mg * b, -1)  # (Mg*B, N)
        with torch.no_grad():
            teacher_global = self.teacher_backbone.forward_features_multimask(x, global_masks)
            t_cls = self.teacher_head(teacher_global["x_norm_regtokens"][:, 0])  # (Mg*B, K)
            t_patch = t_ibot_head(teacher_global["x_norm_patchtokens"])  # (Mg*B, N, Ki)
            if self.centering == "centering":
                t_probs_cls = softmax_center_teacher(self.center, t_cls, teacher_temp)
                t_probs_patch = softmax_center_teacher(self.ibot_center.reshape(1, -1), t_patch, teacher_temp)
            else:
                t_probs_cls = sinkhorn_knopp_teacher(t_cls, teacher_temp, mesh=self.mesh)
                # the rows of patches a view does not keep are left out of the transport problem
                t_probs_patch = sinkhorn_knopp_teacher(
                    t_patch.reshape(-1, t_patch.shape[-1]), teacher_temp, n_samples=keep.sum(), sample_mask=keep.reshape(-1),
                    mesh=self.mesh,
                ).reshape(t_patch.shape)

        # the teacher's global views swapped, so crop A distills crop B
        t_views = list(t_probs_cls.reshape(mg, b, -1))
        t_views = t_views[1:] + t_views[:1]
        n_terms = max(ml * mg, 1) + (mg - 1) * mg
        dino_loss = self.share(dino_cross_entropy(student_views, t_views, self.student_temp) / n_terms)

        n = s_patch.shape[1]
        ibot = ibot_patch_loss_all_pairs(
            s_patch.reshape(mg, b, n, -1), t_probs_patch.reshape(mg, b, n, -1), keep.reshape(mg, b, n), self.student_temp, mesh=self.mesh
        ) / mg

        s_cls_prehead = student_global["x_norm_regtokens"][:, 0].reshape(mg, b, -1)
        koleo = self.koleo_weight * sum(koleo_loss(s_cls_prehead[i], mesh=self.mesh) for i in range(mg))

        aux = {
            "dino_loss": dino_loss,
            "ibot_loss": ibot,
            "koleo_loss": koleo,
            "teacher_logits": t_cls,
            "teacher_patch_logits": t_patch,
            "patch_keep": keep,
        }
        return dino_loss + ibot + koleo, aux

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        x = as_float_image(batch["image"])
        global_masks, local_masks = self.own_masks(generator, x.shape[0])
        temp = self._temp_fn(step)
        loss, aux = self.forward_loss(x, global_masks, local_masks, temp)
        aux["teacher_temp"] = self.share(torch.full((), temp, dtype=torch.float32, device=x.device))
        if self.recon_probe is not None:
            aux["reconstruction_loss"] = probe = self.share(self.probe_loss(x))
            loss = loss + probe
        aux["loss"] = loss
        return loss, aux

    def ema_pairs(self):
        pairs = super().ema_pairs()
        if self.ibot_separate_head:
            pairs.append((self.teacher_ibot_head, self.student_ibot_head))
        return pairs

    @torch.no_grad()
    def on_train_batch_end(self, aux: dict, step: int) -> None:
        """With centering: the CLS center's EMA and the patch center's, whose batch center is each
        sample's mean over its kept tokens, then the mean over samples (momentum 0.9 both; under a
        mesh the global batch's means); then the teachers' EMA."""
        if self.centering == "centering":
            self.center.copy_(update_center(self.center, aux["teacher_logits"], momentum=0.9, mesh=self.mesh))
            t = aux["teacher_patch_logits"].float()
            w = aux["patch_keep"].float()
            per_sample = torch.einsum("bnk,bn->bk", t, w) / torch.clamp(w.sum(1), min=1.0)[:, None]
            self.ibot_center.copy_(update_center(self.ibot_center, per_sample, momentum=0.9, mesh=self.mesh))
        self._teacher_ema(step)
