"""Gumbel-softmax vector quantizer (counterpart of ``m3l_tpu/nn/gumbel_vq.py``; reference
tactile_ssl/model/layers/gumbel_vector_quantizer.py, present but unused in-tree): multi-group
codebooks, a linear projection to group logits, straight-through Gumbel-softmax selection with a
temperature schedule, hard and soft modes, and code perplexity.

The Gumbel noise is -log(-log(u + 1e-10) + 1e-10) of uniform draws u that the caller passes in or
draws with its ``torch.Generator``, never from a global stream: JAX's draws from a key cannot be
matched, so the tests pass them in. ``load_jax_params`` carries ``codebook`` and ``weight_proj``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear


class GumbelVectorQuantizer(nn.Module):
    def __init__(
        self,
        dim: int,
        *,
        num_vars: int = 320,
        groups: int = 2,
        vq_dim: int = 256,
        temp: tuple[float, float, float] = (2.0, 0.5, 0.999995),  # (start, end, decay)
        combine_groups: bool = False,
        hard: bool = True,
        dtype=torch.float32,
    ):
        super().__init__()
        if vq_dim % groups:
            raise ValueError(f"GumbelVectorQuantizer: vq_dim {vq_dim} is not a multiple of groups {groups}")
        self.num_vars = num_vars
        self.groups = groups
        self.combine_groups = combine_groups
        self.hard = hard
        self.temp_start, self.temp_end, self.temp_decay = temp
        n_codebooks = 1 if combine_groups else groups
        self.codebook = nn.Parameter(torch.rand(n_codebooks, num_vars, vq_dim // groups))
        self.weight_proj = Linear(dim, groups * num_vars, dtype=dtype)

    def temperature(self, step) -> torch.Tensor:
        """max(start * decay ** step, end), in f32."""
        decay = torch.tensor(self.temp_decay, dtype=torch.float32)
        return torch.clamp(self.temp_start * decay ** torch.tensor(float(step), dtype=torch.float32), min=self.temp_end)

    def forward(
        self,
        x: torch.Tensor,
        step=0,
        *,
        training: bool = True,
        uniform: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> dict:
        """x (B, T, dim) -> dict(quantized (B, T, vq_dim), perplexity, probs (groups, num_vars)).
        In training, the Gumbel noise comes from ``uniform`` (B, T, groups, num_vars) in [0, 1),
        else from draws with ``generator``."""
        b, t, _ = x.shape
        logits = self.weight_proj(x).reshape(b, t, self.groups, self.num_vars).float()
        if training:
            if uniform is None:
                if generator is None:
                    raise ValueError("GumbelVectorQuantizer: training needs the uniform draws or a torch.Generator")
                uniform = torch.rand(logits.shape, generator=generator, device=logits.device)
            g = -torch.log(-torch.log(uniform.to(logits.device, torch.float32) + 1e-10) + 1e-10)
            tau = self.temperature(step).to(logits.device)
            soft = torch.softmax((logits + g) / tau, dim=-1)
        else:
            soft = torch.softmax(logits, dim=-1)
        hard = F.one_hot(soft.argmax(dim=-1), self.num_vars).to(soft.dtype)
        sel = hard + soft - soft.detach() if (self.hard and training) else soft
        codebook = self.codebook
        if self.combine_groups:
            codebook = codebook.expand(self.groups, *codebook.shape[1:])
        quantized = torch.einsum("btgv,gvd->btgd", sel, codebook.to(sel.dtype)).reshape(b, t, -1)
        avg_probs = soft.reshape(-1, self.groups, self.num_vars).mean(dim=0)
        perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-7), dim=-1)).sum()
        return {"quantized": quantized, "perplexity": perplexity, "probs": avg_probs}
