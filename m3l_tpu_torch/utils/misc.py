"""Small utilities (counterpart of ``m3l_tpu/utils/misc.py``, reference
tactile_ssl/utils/__init__.py parity).

* quaternion ops (:72-131): multiply, conjugate, rotate, to/from axis-angle, on tensors of any
  device and float dtype (array-likes become tensors);
* ``create_ndgrid`` (:39-69), on a chosen device;
* ``AverageMeter`` (:194-217).
"""
from __future__ import annotations

import torch


def quaternion_multiply(q1, q2) -> torch.Tensor:
    """Hamilton product, quaternions as (..., 4) wxyz."""
    w1, x1, y1, z1 = torch.as_tensor(q1).split(1, dim=-1)
    w2, x2, y2, z2 = torch.as_tensor(q2).split(1, dim=-1)
    return torch.cat(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quaternion_conjugate(q) -> torch.Tensor:
    q = torch.as_tensor(q)
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quaternion_apply(q, v) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    v = torch.as_tensor(v)
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    return quaternion_multiply(quaternion_multiply(q, qv), quaternion_conjugate(q))[..., 1:]


def axis_angle_to_quaternion(axis_angle) -> torch.Tensor:
    aa = torch.as_tensor(axis_angle)
    # sqrt(sum + eps^2) keeps the gradient finite at aa == 0; the forward shift is < 1e-8
    angle = torch.sqrt(torch.sum(aa * aa, dim=-1, keepdim=True) + 1e-16)
    half = angle * 0.5
    sin_half = torch.where(angle > 1e-8, torch.sin(half) / torch.clamp(angle, min=1e-8), torch.full_like(angle, 0.5))
    return torch.cat([torch.cos(half), aa * sin_half], dim=-1)


def quaternion_to_axis_angle(q) -> torch.Tensor:
    q = torch.as_tensor(q)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    angle = 2.0 * torch.arccos(w)
    s = torch.sqrt(torch.clamp(1.0 - w**2, min=1e-12))
    return q[..., 1:] / s * angle


def create_ndgrid(*sizes, device: str | torch.device = "cpu") -> torch.Tensor:
    """(prod(sizes), len(sizes)) int64 grid, row-major (reference utils/__init__.py:39-69)."""
    mesh = torch.meshgrid(*[torch.arange(s, device=device) for s in sizes], indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


class AverageMeter:
    """Running average (reference utils/__init__.py:194-217); values may be 0-d tensors."""

    def __init__(self, name: str = "", fmt: str = ":f"):
        self.name, self.fmt = name, fmt
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:{self.fmt.strip(':')}} ({self.avg:{self.fmt.strip(':')}})"
