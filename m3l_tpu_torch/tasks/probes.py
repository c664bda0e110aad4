"""Downstream probe heads over frozen or fine-tuned encoder tokens (counterpart of
``m3l_tpu/tasks/probes.py``).

Each pools the tokens with an :class:`AttentivePooler` (one query) and maps the pooled token
through a two-layer MLP (dim -> dim / 4 -> out): force (3 DoF, optionally tanh / sigmoid last
activations), slip (classes; :class:`SlipForceProbe` also takes a (delta-)force vector), pose
(three heads of bins: x, y, theta), grasp (2 classes) and textile (20 classes). Outputs are f32.
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.vit import VIT_EMBED_DIMS
from ..nn.layers import Linear
from .attentive_pooler import AttentivePooler


def _dim(embed_dim) -> int:
    if isinstance(embed_dim, str):
        return VIT_EMBED_DIMS[f"vit_{embed_dim}"]
    return int(embed_dim)


def _mlp_head(dim: int, out: int, dtype) -> nn.ModuleList:
    return nn.ModuleList([Linear(dim, dim // 4, dtype=dtype), Linear(dim // 4, out, dtype=dtype)])


def _run_head(head: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    return head[1](torch.relu(head[0](x)))


def _pooler(dim: int, num_heads: int, depth: int, dtype) -> AttentivePooler:
    return AttentivePooler(num_queries=1, embed_dim=dim, num_heads=num_heads, depth=depth, dtype=dtype)


class ForceLinearProbe(nn.Module):
    def __init__(self, embed_dim="base", *, num_heads: int = 12, depth: int = 1, with_last_activations: bool = False, dtype=torch.float32):
        super().__init__()
        dim = _dim(embed_dim)
        self.pooler = _pooler(dim, num_heads, depth, dtype)
        self.head = _mlp_head(dim, 3, dtype)
        self.with_last_activations = with_last_activations

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        y = _run_head(self.head, self.pooler(tokens)[:, 0]).float()
        if self.with_last_activations:
            y = torch.cat([torch.tanh(y[:, :2]), torch.sigmoid(y[:, 2:])], dim=-1)
        return y


class _ClassProbe(nn.Module):
    """Pooler and one MLP head of ``num_classes`` logits."""

    def __init__(self, embed_dim="base", *, num_classes: int = 2, num_heads: int = 12, depth: int = 1, dtype=torch.float32):
        super().__init__()
        dim = _dim(embed_dim)
        self.pooler = _pooler(dim, num_heads, depth, dtype)
        self.head = _mlp_head(dim, num_classes, dtype)
        self.num_classes = num_classes

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return _run_head(self.head, self.pooler(tokens)[:, 0]).float()


class SlipProbe(_ClassProbe):
    pass


class GraspLinearProbe(_ClassProbe):
    pass


class TextileLinearProbe(_ClassProbe):
    def __init__(self, embed_dim="base", *, num_classes: int = 20, **kwargs):
        super().__init__(embed_dim, num_classes=num_classes, **kwargs)


class SlipForceProbe(nn.Module):
    """Slip classifier conditioned on a (delta-)force vector."""

    def __init__(self, embed_dim="base", *, num_classes: int = 2, force_dim: int = 3, num_heads: int = 12, depth: int = 1, dtype=torch.float32):
        super().__init__()
        dim = _dim(embed_dim)
        self.pooler = _pooler(dim, num_heads, depth, dtype)
        self.force_proj = Linear(force_dim, dim // 4, dtype=dtype)
        self.fc1 = Linear(dim + dim // 4, dim // 4, dtype=dtype)
        self.fc2 = Linear(dim // 4, num_classes, dtype=dtype)
        self.num_classes = num_classes

    def forward(self, tokens: torch.Tensor, force: torch.Tensor) -> torch.Tensor:
        pooled = self.pooler(tokens)[:, 0]
        f = torch.relu(self.force_proj(force.to(pooled.dtype)))
        h = torch.relu(self.fc1(torch.cat([pooled, f], dim=-1)))
        return self.fc2(h).float()


class PoseLinearProbe(nn.Module):
    def __init__(self, embed_dim="base", *, num_classes: int = 10, num_heads: int = 12, depth: int = 1, dtype=torch.float32):
        super().__init__()
        dim = _dim(embed_dim)
        self.num_classes = num_classes
        self.pooler = _pooler(dim, num_heads, depth, dtype)
        self.head_x = _mlp_head(dim, num_classes, dtype)
        self.head_y = _mlp_head(dim, num_classes, dtype)
        self.head_theta = _mlp_head(dim, num_classes, dtype)

    def forward(self, tokens: torch.Tensor) -> dict:
        pooled = self.pooler(tokens)[:, 0]
        return {
            "x": _run_head(self.head_x, pooled).float(),
            "y": _run_head(self.head_y, pooled).float(),
            "theta": _run_head(self.head_theta, pooled).float(),
        }
