"""Fused attention on the packed qkv projection: the CUDA kernel and its plain version.

Counterpart of ``m3l_tpu/nn/flash_attention.py`` ``flash_attention_qkv`` (the Pallas kernel
``_fwd_qkv_kernel``). The kernel is ``csrc/flash_attention_qkv_fwd.cu``; its source note gives
the design and the bound on the H100. On a CUDA tensor the wrapper launches the kernel or
raises; on a CPU tensor it runs :func:`flash_attention_qkv_reference`, the same arithmetic in
plain PyTorch. Forward only: the backward kernel and the ``autograd.Function`` come with
training, so CUDA inputs that require grad are refused.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import LAUNCHES
from ..kernels.build import load_library

KERNEL = "flash_attention_qkv_fwd"
MAX_HEAD_DIM = 128


def _key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool, True = attend -> f32 additive key bias, 0 or -1e30."""
    zero = torch.zeros((), dtype=torch.float32, device=key_mask.device)
    return torch.where(key_mask, zero, torch.full_like(zero, -1e30))


def flash_attention_qkv_reference(
    qkv: torch.Tensor, num_heads: int, *, key_mask: torch.Tensor | None = None, scale: float | None = None
) -> torch.Tensor:
    """Plain version: (B, N, 3*H*Dh) -> (B, N, H*Dh).

    Scores, max, exp and sum in f32; the probabilities rounded to the input dtype before A.V,
    which sums in f32; the result rounded to the input dtype."""
    b, n, thd = qkv.shape
    hd = thd // 3
    dh = hd // num_heads
    if scale is None:
        scale = dh**-0.5
    x = qkv.reshape(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4).float()  # (3, B, H, N, Dh)
    q, k, v = x[0], x[1], x[2]
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if key_mask is not None:
        s = s + _key_bias(key_mask)[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    a = (e / e.sum(dim=-1, keepdim=True)).to(qkv.dtype).float()
    o = torch.matmul(a, v)  # (B, H, N, Dh)
    return o.permute(0, 2, 1, 3).reshape(b, n, hd).to(qkv.dtype)


def flash_attention_qkv_tolerance(
    qkv: torch.Tensor, num_heads: int, ref: torch.Tensor, *, key_mask: torch.Tensor | None = None, scale: float | None = None
) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for ``qkv``, given the plain result ``ref`` (f32).

    float32: 1e-5; both compute the same f32 products, exp and division, and differ only in
    summation order. Lower precision: the two agree to ~1e-6 relative in f32, then each rounds
    twice to the input type, and either rounding can land them on adjacent values. Rounding the
    output costs at most one ulp of |ref|. Rounding a probability p_j costs at most one ulp of
    p_j, at most eps * p_j, so at most eps * sum_j p_j |v_j| on an output: the plain version run
    with |v|. The second term keeps outputs near 0, whose ulp is tiny, inside the bound."""
    if qkv.dtype == torch.float32:
        return torch.full(ref.shape, 1e-5, device=ref.device)
    eps = torch.finfo(qkv.dtype).eps
    hd = qkv.shape[-1] // 3
    abs_v = torch.cat([qkv[..., : 2 * hd], qkv[..., 2 * hd :].abs()], dim=-1)
    pv = flash_attention_qkv_reference(abs_v, num_heads, key_mask=key_mask, scale=scale).float()
    mag = ref.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag))) * eps + eps * pv + 1e-6


_SIGNATURES = {
    "m3l_flash_qkv_fwd_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_size_t),
    "m3l_flash_qkv_fwd": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def _launch(qkv: torch.Tensor, num_heads: int, key_mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    b, n, thd = qkv.shape
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention_qkv: dtype {qkv.dtype} not supported (bfloat16 or float32)")
    if qkv.requires_grad:
        raise NotImplementedError("flash_attention_qkv: no backward kernel yet; run under torch.inference_mode()")
    if thd % (3 * num_heads):
        raise ValueError(f"flash_attention_qkv: last dim {thd} is not 3 * heads({num_heads}) * head_dim")
    dh = thd // (3 * num_heads)
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_qkv: head_dim {dh} must be a multiple of 8 and at most {MAX_HEAD_DIM}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_qkv: qkv must be contiguous and 16-byte aligned")
    if b > 65535 or num_heads > 65535:
        raise ValueError(f"flash_attention_qkv: batch {b} and heads {num_heads} must each be at most 65535")
    lib = load_library(KERNEL, _SIGNATURES)
    smem = lib.m3l_flash_qkv_fwd_smem_bytes(n, dh, qkv.element_size())
    limit = torch.cuda.get_device_properties(qkv.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"flash_attention_qkv: N={n}, head_dim={dh} needs {smem} B of shared memory, the card has {limit}")
    bias = None
    if key_mask is not None:
        if key_mask.shape != (b, n) or key_mask.dtype != torch.bool or key_mask.device != qkv.device:
            raise ValueError(f"flash_attention_qkv: key_mask must be bool ({b}, {n}) on {qkv.device}")
        bias = _key_bias(key_mask).contiguous()
    out = torch.empty((b, n, thd // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.m3l_flash_qkv_fwd(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, n, num_heads, dh, float(scale), qkv.element_size(), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_qkv: kernel launch failed with CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return out


def flash_attention_qkv(
    qkv: torch.Tensor, num_heads: int, *, key_mask: torch.Tensor | None = None, scale: float | None = None
) -> torch.Tensor:
    """Fused attention on the packed qkv tensor (B, N, 3*H*Dh) -> (B, N, H*Dh)."""
    if qkv.dim() != 3:
        raise ValueError(f"flash_attention_qkv: qkv must be (B, N, 3*H*Dh), got {tuple(qkv.shape)}")
    if scale is None:
        scale = (qkv.shape[-1] // (3 * num_heads)) ** -0.5
    if qkv.device.type == "cuda":
        return _launch(qkv, num_heads, key_mask, scale)
    if qkv.device.type == "cpu":
        return flash_attention_qkv_reference(qkv, num_heads, key_mask=key_mask, scale=scale)
    raise ValueError(f"flash_attention_qkv: no kernel for device {qkv.device}")
