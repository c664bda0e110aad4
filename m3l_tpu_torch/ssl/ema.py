"""Exponential-moving-average teacher update (counterpart of ``m3l_tpu/ssl/ema.py``).

teacher = decay * teacher + (1 - decay) * student over matching parameters, in place, after each
train batch. ``decay`` and ``1 - decay`` are f32 scalars, as jnp forms them from the f32 schedule
value (a Python-float ``1 - decay`` is formed in double and rounds differently).
"""
from __future__ import annotations

from typing import Iterable

import torch


@torch.no_grad()
def ema_update(teacher: Iterable[torch.Tensor], student: Iterable[torch.Tensor], decay) -> None:
    """``teacher`` and ``student``: matching tensors (``module.parameters()`` of a teacher and its
    student); each teacher tensor becomes t * decay + s * (1 - decay)."""
    teacher, student = list(teacher), list(student)
    if len(teacher) != len(student):
        raise ValueError(f"ema_update: {len(teacher)} teacher tensors for {len(student)} student tensors")
    if not teacher:
        return
    d = torch.as_tensor(decay, dtype=torch.float32).to(teacher[0].device)
    one_minus = 1.0 - d
    torch._foreach_mul_(teacher, d)
    torch._foreach_add_(teacher, torch._foreach_mul([s.to(t.dtype) for t, s in zip(teacher, student)], one_minus))
