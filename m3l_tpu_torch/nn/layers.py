"""Layers with flax's mixed-precision semantics, written out by hand (no autocast).

Parameters stay float32. ``Linear``, ``Conv2d`` and ``Conv3d`` cast their input, weight and bias
to the compute dtype (matrix products accumulate in f32 on the card and round once to the
compute dtype); ``LayerNorm`` takes its statistics in f32 and casts its output to the compute dtype,
as ``nnx.Linear`` / ``nnx.Conv`` / ``nnx.LayerNorm`` do with ``param_dtype=float32``.
``BatchNorm2d`` is ``nnx.BatchNorm(use_running_average=True)``: it normalises by its running
statistics in train mode too and never updates them.
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

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1, padding: int = 0, *, bias: bool = True, dtype=torch.float32
    ):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding)


class Conv3d(nn.Conv3d):
    """NCDHW convolution; the weight is OIDHW (flax's DHWIO transposed)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1, *, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv3d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim: int, eps: float = 1e-5, *, dtype=torch.float32):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


class BatchNorm2d(nn.Module):
    """Per-channel normalisation of NCHW inputs by the running statistics, flax's order of
    operations in the compute dtype: (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, num_features: int, eps: float = 1e-5, *, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        mul = torch.rsqrt(self.running_var.to(dt) + self.eps) * self.weight.to(dt)
        return (x.to(dt) - self.running_mean.to(dt)[:, None, None]) * mul[:, None, None] + self.bias.to(dt)[:, None, None]
