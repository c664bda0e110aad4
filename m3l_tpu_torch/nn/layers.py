"""Layers with flax's mixed-precision semantics, written out by hand (no autocast).

Parameters stay float32. ``Linear`` and ``Conv2d`` cast their input, weight and bias to the
compute dtype (matrix products accumulate in f32 on the card and round once to the compute
dtype); ``LayerNorm`` takes its statistics in f32 and casts its output to the compute dtype,
as ``nnx.Linear`` / ``nnx.Conv`` / ``nnx.LayerNorm`` do with ``param_dtype=float32``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True, *, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """NCHW convolution; the weight is OIHW (flax's HWIO transposed)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1, padding: int = 0, *, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride, self.padding)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int, eps: float = 1e-5, *, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)
