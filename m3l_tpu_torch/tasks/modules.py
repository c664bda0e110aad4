"""Per-task supervised probe modules, T1-T4 and T6 (counterpart of ``m3l_tpu/tasks/modules.py``).

* Force: smooth-L1 with beta 0.02; per-axis RMSE after rescaling by the batch's ``force_scale``.
* Slip: class-weighted cross-entropy, optionally on a (delta-)force input too.
* Pose: three class-weighted cross-entropy heads (x / y / theta bins), summed.
* Grasp and textile: class-weighted cross-entropy.

Class weights are non-persistent buffers: they follow the module to its device and stay out of
its state dict, as the JAX modules keep them as plain arrays.

On a mesh (``SSLModule.use_mesh``) every loss and scalar is this rank's share of the global
batch's value, as JAX's GSPMD Trainer computes it: :func:`weighted_ce` divides by the class
weights applied over the whole global batch, and :func:`batch_rmse` takes its squared errors and
row count over the dp group before the square root.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ssl.losses import dp_sum
from .sl_module import SLModuleBase


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    diff = torch.abs(pred - target)
    return torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor, weights: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """Per-sample weighted NLL over the sum of the applied weights (clipped at 1e-8), as
    ``F.cross_entropy(weight=...)`` reduces it while any weight is non-zero. Under ``mesh`` this
    rank's share of the global batch's value: its rows' weighted sum over the weights applied in
    the whole global batch (summed over the dp group; a constant of the labels, so no gradient),
    or its rows' mean over dp without weights."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.take_along_dim(logp, labels[:, None], dim=1)[:, 0]
    if weights is None:
        return nll.mean() if mesh is None else nll.mean() / mesh.dp
    w = weights[labels]
    if mesh is None:
        return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)
    return (nll * w).sum() / torch.clamp(dp_sum(w.sum().detach().reshape(1), mesh)[0], min=1e-8)


def batch_rmse(sq_err: torch.Tensor, mesh=None) -> torch.Tensor:
    """The root of the batch mean of each column of squared errors (B, k), the same on every rank:
    under ``mesh`` the sums and the row count are taken over the dp group first, since a square
    root does not split into the ranks' shares."""
    if mesh is None:
        return torch.sqrt(torch.mean(sq_err, dim=0))
    sums = dp_sum(torch.cat([sq_err.detach().sum(dim=0), sq_err.new_full((1,), sq_err.shape[0])]), mesh)
    return torch.sqrt(sums[:-1] / sums[-1])


def _weights(values) -> Optional[torch.Tensor]:
    return None if values is None else torch.as_tensor(values, dtype=torch.float32)


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, -1) == labels).float().mean()


class ForceSLModule(SLModuleBase):
    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        x, y_gt = batch["image"], batch["force"]
        y_pred = self.model_task(self.encode(x))
        loss = self.share(smooth_l1(y_pred, y_gt, beta=0.02).mean())
        scale = batch.get("force_scale", torch.ones_like(y_gt))
        rmse = batch_rmse((y_pred.detach() * scale - y_gt * scale) ** 2, self.mesh)
        return loss, {"loss": loss, **{f"rmse_{a}": self.share(rmse[i]) for i, a in enumerate("xyz")}}

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.model_task(self.encode(x))


class _ClassSLModule(SLModuleBase):
    """One classification head over ``batch[label_key]``, with optional class weights."""

    label_key = ""

    def __init__(self, *args, class_weights=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_buffer("class_weights", _weights(class_weights), persistent=False)

    def logits(self, batch: dict) -> torch.Tensor:
        return self.model_task(self.encode(batch["image"]))

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        logits = self.logits(batch)
        labels = batch[self.label_key].long()
        loss = weighted_ce(logits, labels, self.class_weights, self.mesh)
        return loss, {"loss": loss, "accuracy": self.share(_accuracy(logits, labels))}

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.model_task(self.encode(x))


class SlipSLModule(_ClassSLModule):
    label_key = "slip"

    def __init__(self, *args, use_force: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_force = use_force

    def logits(self, batch: dict) -> torch.Tensor:
        tokens = self.encode(batch["image"])
        return self.model_task(tokens, batch["force"]) if self.use_force else self.model_task(tokens)

    def predict(self, x: torch.Tensor, force: Optional[torch.Tensor] = None) -> torch.Tensor:
        tokens = self.encode(x)
        return self.model_task(tokens, force) if self.use_force else self.model_task(tokens)


class GraspSLModule(_ClassSLModule):
    label_key = "grasp"


class TextileSLModule(_ClassSLModule):
    label_key = "textile"


class PoseSLModule(SLModuleBase):
    HEADS = ("x", "y", "theta")

    def __init__(self, *args, class_weights: Optional[dict] = None, **kwargs):
        super().__init__(*args, **kwargs)
        for head in self.HEADS:
            self.register_buffer(f"class_weights_{head}", _weights((class_weights or {}).get(head)), persistent=False)

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        preds = self.model_task(self.encode(batch["image"]))
        losses, accs = {}, {}
        for head in self.HEADS:
            labels = batch[f"pose_{head}"].long()
            losses[head] = weighted_ce(preds[head], labels, getattr(self, f"class_weights_{head}"), self.mesh)
            accs[head] = self.share(_accuracy(preds[head], labels))
        loss = sum(losses.values())
        aux = {"loss": loss}
        aux.update({f"loss_{k}": v for k, v in losses.items()})
        aux.update({f"acc_{k}": v for k, v in accs.items()})
        return loss, aux

    def predict(self, x: torch.Tensor) -> dict:
        return self.model_task(self.encode(x))
