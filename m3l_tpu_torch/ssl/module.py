"""SSL algorithm protocol and its optimizer (counterpart of ``m3l_tpu/ssl/module.py``).

* :meth:`SSLModule.training_loss`: (batch, generator, step) -> (loss, aux); the Trainer
  differentiates it with respect to :meth:`SSLModule.trainable_parameters`.
* :meth:`SSLModule.on_train_batch_end`: the post-update hook (EMA teachers, loss centers).
* :meth:`SSLModule.use_mesh`: train on a dp x mp mesh (``train/mesh.py``). A module then draws its
  masks or noise for the global batch (every rank the same bits, from the same generator) and
  keeps this rank's rows (:meth:`SSLModule.own_rows`), takes every batch statistic over the dp
  group, and returns its loss and every scalar of its aux as this rank's share of the global value
  (:meth:`SSLModule.share`), which the Trainer sums over the ranks.
* :meth:`SSLModule.configure_optimizer`: AdamW with the weight-decay split (>= 2-D parameters
  decayed) and the warm-up-cosine lr / cosine wd schedules; the flat-buffer AdamW
  (``train/optim.py`` :class:`FlatAdamW`) where a module sets ``_flat_optimizer``, as JAX's
  ``scripts/bench_ssl.py`` does.

:class:`WDSplitAdamW` is ``optax.inject_hyperparams(optax.adamw)(lr, wd, b1, b2, mask=wd_mask)``
on ``torch.optim.AdamW`` with two parameter groups, optionally behind ``clip_by_global_norm``
and ``optax.MultiSteps`` (``train/optim.py`` :class:`GradientChain`), as the Trainer chains them.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import torch
from torch import nn

from ..train.mesh import gather_like, shard_like
from ..train.optim import FlatAdamW, GradientChain
from .schedulers import cosine_wd_schedule, warmup_cosine_schedule



class SSLModule(nn.Module):
    mesh = None  # the dp x mp mesh the module trains on (use_mesh), None for one process

    def trainable_parameters(self) -> dict[str, nn.Parameter]:
        """The parameters the optimizer moves, by name (all of them unless a module keeps a
        teacher)."""
        return dict(self.named_parameters())

    def training_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        raise NotImplementedError

    def validation_loss(self, batch: dict, generator: Optional[torch.Generator], step: int):
        return self.training_loss(batch, generator, step)

    def on_train_batch_end(self, aux: dict, step: int) -> None:
        """Post-update hook (EMA, centers). Default: nothing."""

    def use_mesh(self, mesh) -> None:
        """Train under ``mesh`` (``train/mesh.py``): the loss becomes this rank's share of the
        global batch's (see the module docstring)."""
        self.mesh = mesh

    def global_rows(self, rows: int) -> int:
        """The global batch of which this rank holds ``rows``: rows x dp under a mesh."""
        return rows if self.mesh is None else rows * self.mesh.dp

    def own_rows(self, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's rows of ``t``, a global batch along ``axis`` (masks drawn for it); ``t``
        itself without a mesh."""
        if self.mesh is None:
            return t
        rows = self.mesh.rows(t.shape[axis])
        return t.narrow(axis, rows.start, rows.stop - rows.start)

    def share(self, value):
        """This rank's share of a mean over the global batch, from the mean over its rows (every
        rank holds as many): value / dp under a mesh, value itself without one. A value the same
        on every rank (a temperature) is shared so too, so the Trainer's sum gives it back."""
        return value if self.mesh is None else value / self.mesh.dp

    def configure_optimizer(self, steps_per_epoch: int, epochs: int) -> GradientChain:
        return default_wd_split_optimizer(
            self.trainable_parameters().values(),
            base_lr=getattr(self, "base_lr", 1e-4),
            total_steps=steps_per_epoch * epochs,
            steps_per_epoch=steps_per_epoch,
            warmup_epochs=getattr(self, "warmup_epochs", 10),
            start_lr=getattr(self, "start_lr", 0.0),
            final_lr=getattr(self, "final_lr", 0.0),
            weight_decay=getattr(self, "weight_decay", 0.04),
            final_weight_decay=getattr(self, "final_weight_decay", None),
            betas=getattr(self, "betas", (0.9, 0.999)),
            # the flat-buffer AdamW: an opt-in, set on the module before fit()
            flat=getattr(self, "_flat_optimizer", False),
        )


def as_float_image(x: torch.Tensor) -> torch.Tensor:
    """uint8 images to f32 in [0, 1] on their device; float inputs pass through."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x


def wd_mask(params: Iterable[torch.Tensor]) -> list[bool]:
    """Decay only >= 2-D parameters."""
    return [p.dim() >= 2 for p in params]


class WDSplitAdamW(GradientChain):
    """AdamW over ``params`` in two groups (decayed where :func:`wd_mask` holds, else not), lr and
    wd read from their schedules at the pre-increment count before every update, as optax's
    ``inject_hyperparams`` does. The update is -lr (m_hat / (sqrt(v_hat) + eps) + wd p), behind
    the chain's clipping and accumulation (:class:`GradientChain`)."""

    def __init__(
        self,
        params: Iterable[nn.Parameter],
        learning_rate: Callable[[int], float],
        weight_decay: float | Callable[[int], float],
        betas=(0.9, 0.999),
        eps: float = 1e-8,
        clip_norms: Sequence[float] = (),
        every_k: int = 1,
    ):
        super().__init__(params, clip_norms, every_k)
        decay = [p for p, m in zip(self.params, wd_mask(self.params)) if m]
        no_decay = [p for p, m in zip(self.params, wd_mask(self.params)) if not m]
        groups = [{"params": decay}, {"params": no_decay, "weight_decay": 0.0}]
        self.adamw = torch.optim.AdamW([g for g in groups if g["params"]], lr=0.0, betas=tuple(betas), eps=eps, weight_decay=0.0)
        self._decay_group = self.adamw.param_groups[0] if decay else None
        self.learning_rate, self.weight_decay = learning_rate, weight_decay

    def _apply(self, grads: list[torch.Tensor]) -> None:
        for p, g in zip(self.params, grads):
            p.grad = g
        wd = self.weight_decay(self.count) if callable(self.weight_decay) else self.weight_decay
        for group in self.adamw.param_groups:
            group["lr"] = self.learning_rate(self.count)
        if self._decay_group is not None:
            self._decay_group["weight_decay"] = wd
        self.adamw.step()

    def _ordered(self) -> list[nn.Parameter]:
        """The parameters in the order ``torch.optim`` numbers them in its state dict."""
        return [p for g in self.adamw.param_groups for p in g["params"]]

    def _map_moments(self, sd: dict, fn) -> dict:
        params = self._ordered()
        state = {i: {k: fn(v, params[i]) if k in ("exp_avg", "exp_avg_sq") else v for k, v in st.items()} for i, st in sd["state"].items()}
        return {**sd, "state": state}

    def state_dict(self) -> dict:
        """AdamW's state and the chain's, in the single-process layout (collective under a mesh)."""
        adamw = self.adamw.state_dict()
        if self.mesh is not None:
            adamw = self._map_moments(adamw, lambda t, p: gather_like(t, p, self.mesh))
        return {"adamw": adamw, **super().state_dict()}

    def load_state_dict(self, d: dict) -> None:
        """Restore a :meth:`state_dict`; AdamW's moments land on their parameters' devices (under
        a mesh, this rank's shares)."""
        adamw = d["adamw"]
        if self.mesh is not None:
            adamw = self._map_moments(adamw, lambda t, p: shard_like(t.to(p.device), p, self.mesh))
        self.adamw.load_state_dict(adamw)
        super().load_state_dict(d)


def default_wd_split_optimizer(
    params: Iterable[nn.Parameter],
    *,
    base_lr: float,
    total_steps: int,
    steps_per_epoch: int,
    warmup_epochs: int = 10,
    start_lr: float = 0.0,
    final_lr: float = 0.0,
    weight_decay: float = 0.04,
    final_weight_decay: Optional[float] = None,
    betas=(0.9, 0.999),
    clip_norm: Optional[float] = None,
    flat: bool = False,
) -> GradientChain:
    """AdamW with the weight-decay split and the schedules: :class:`WDSplitAdamW`, or with
    ``flat`` the flat-buffer :class:`FlatAdamW` (the same updates up to rounding order), each
    behind global-norm clipping at ``clip_norm`` when it is set, as ``optax.chain`` puts it."""
    lr = warmup_cosine_schedule(base_lr, start_lr, final_lr, warmup_epochs * steps_per_epoch, total_steps)
    wd = cosine_wd_schedule(weight_decay, final_weight_decay, total_steps) if final_weight_decay is not None else weight_decay
    adamw = FlatAdamW if flat else WDSplitAdamW
    return adamw(params, lr, wd, betas=betas, clip_norms=() if clip_norm is None else (clip_norm,))
