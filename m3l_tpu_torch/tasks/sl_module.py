"""Supervised-probe harness over frozen or fine-tuned encoders (counterpart of
``m3l_tpu/tasks/sl_module.py``).

An encoder plus a task head under the SSL Trainer. The encoder may be loaded from an SSL
checkpoint of the port's Trainer with the same key surgery as the JAX package ("jepa" -> the
target encoder, "dino" -> the teacher backbone or encoder, else the encoder; then a nested
``backbone``). Unless ``train_encoder``, the encoder is frozen: it runs under ``torch.no_grad()``
(no saved activations, no backward) and its parameters stay out of the optimizer, so weight decay
cannot move them either.

On a mesh (``Trainer(mesh=...)``) the encoder and the probe are sharded as every module is
(``train/mesh.py`` :func:`shard_module`): a frozen encoder still runs its row-parallel sums under
``torch.no_grad()``, and its shards stay out of the optimizer. The encoder is loaded from its
checkpoint when the module is built, before the Trainer shards anything, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ssl.module import SSLModule, as_float_image
from ..train.checkpoint import load_checkpoint


class EncoderWrapper(nn.Module):
    """encoder -> patch tokens (B, N, D), whichever forward the encoder has."""

    def __init__(self, encoder: nn.Module):
        super().__init__()
        self.encoder = encoder

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self.encoder, "forward_features"):
            return self.encoder.forward_features(x)["x_norm_patchtokens"]
        return self.encoder(x)


def _subtree(state: dict, prefix: str) -> dict:
    return {k[len(prefix) :]: v for k, v in state.items() if k.startswith(prefix)}


def load_encoder_from_checkpoint(encoder: nn.Module, ckpt_path: str, encoder_type: str = "jepa") -> None:
    """Load ``encoder``'s state from a Trainer checkpoint (``payload["model"]``, a state dict):
    the ``target_encoder`` of a "jepa" type, the ``teacher_backbone`` (else ``teacher_encoder``)
    of a "dino" type, else the ``encoder``; inside it, the ``backbone`` where there is one. Every
    parameter of ``encoder`` must be found, at its shape."""
    payload = load_checkpoint(ckpt_path)
    state = payload["model"] if "model" in payload else payload
    if "jepa" in encoder_type:
        keys = ["target_encoder"]
    elif "dino" in encoder_type:
        keys = ["teacher_backbone", "teacher_encoder"]
    else:
        keys = ["encoder"]
    sub = next((s for s in (_subtree(state, k + ".") for k in keys) if s), None)
    if sub is None:
        tops = sorted({k.split(".")[0] for k in state})
        raise KeyError(f"no encoder subtree {keys} in checkpoint {ckpt_path}; top-level keys: {tops[:10]}")
    if any(k.startswith("backbone.") for k in sub):
        sub = _subtree(sub, "backbone.")
    encoder.load_state_dict(sub)


class SLModuleBase(SSLModule):
    def __init__(
        self,
        model_encoder: nn.Module,
        model_task: nn.Module,
        *,
        checkpoint_encoder: Optional[str] = None,
        encoder_type: str = "jepa",
        train_encoder: bool = False,
        base_lr: float = 1e-4,
        weight_decay: float = 0.04,
        warmup_epochs: int = 1,
    ):
        super().__init__()
        self.model_encoder = model_encoder if isinstance(model_encoder, EncoderWrapper) else EncoderWrapper(model_encoder)
        self.model_task = model_task
        self.train_encoder = train_encoder
        self.encoder_type = encoder_type
        self.base_lr = base_lr
        self.weight_decay = weight_decay
        self.warmup_epochs = warmup_epochs
        if checkpoint_encoder is not None:
            load_encoder_from_checkpoint(self.model_encoder.encoder, checkpoint_encoder, encoder_type)

    def trainable_parameters(self) -> dict[str, nn.Parameter]:
        """The probe's parameters, and the encoder's too when it is fine-tuned."""
        return {n: p for n, p in self.named_parameters() if self.train_encoder or not n.startswith("model_encoder.")}

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Patch tokens of ``x``; a frozen encoder runs without autograd."""
        x = as_float_image(x)
        if self.train_encoder:
            return self.model_encoder(x)
        with torch.no_grad():
            return self.model_encoder(x)
