"""The arithmetic the plain references compute in: float32 with TF32 off, or one of the controls'
lower precisions.

* ``f32``: every product in float32, TF32 off in cuBLAS and cuDNN.
* ``tf32``: the same operations with TF32 on in cuBLAS and cuDNN (the control of a float32
  configuration).
* ``fp8``: every product (linear layers, convolutions, attention's two batched products) takes
  operands rounded to float8 e4m3 with one scale per tensor (its absolute maximum mapped to 448),
  forward and backward; sums stay float32 (the control of a bfloat16 configuration).
* ``bf16``: every product takes operands rounded to bfloat16, sums stay float32: what rounding to
  a bfloat16 configuration's own precision moves a result, the gauge that a bfloat16 program's gap
  from the float32 reference is measured in.

Plain PyTorch only: nothing here imports the program.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

KINDS = ("f32", "tf32", "fp8", "bf16")
FP8_MAX = 448.0


def quantize_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, returned in float32."""
    x = x.float()
    amax = x.abs().max()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize_fp8(a), quantize_fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize_fp8(g)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        # broadcast batch dimensions back to the operands' shapes
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


class _Fp8Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        qx, qw = quantize_fp8(x), quantize_fp8(w)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, padding)
        return F.conv2d(qx, qw, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        stride, padding = ctx.conf
        qg = quantize_fp8(g)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, stride, padding)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, stride, padding)
        return gx, gw, None, None


class Numerics:
    """The products of a reference, in one of :data:`KINDS`."""

    def __init__(self, kind: str = "f32"):
        if kind not in KINDS:
            raise ValueError(f"numerics {kind!r}: one of {KINDS}")
        self.kind = kind

    def _round(self, *xs):
        if self.kind == "bf16":
            return tuple(x.to(torch.bfloat16).float() for x in xs)
        return xs

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp8":
            return _Fp8Matmul.apply(a, b)
        return torch.matmul(*self._round(a, b))

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
        y = self.matmul(x, w.t()) if self.kind == "fp8" else F.linear(*self._round(x, w))
        return y if b is None else y + b

    def conv2d(self, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, stride: int, padding: int) -> torch.Tensor:
        if self.kind == "fp8":
            y = _Fp8Conv2d.apply(x, w, stride, padding)
            return y if b is None else y + b[None, :, None, None]
        return F.conv2d(*self._round(x, w), b, stride, padding)


@contextlib.contextmanager
def numerics(kind: str = "f32"):
    """A :class:`Numerics` of ``kind`` with the TF32 flags it needs set, restored on exit."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    tf32 = kind == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield Numerics(kind)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
