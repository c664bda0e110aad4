"""Fused attention: the CUDA kernels and their plain versions, for both interfaces of
``m3l_tpu/nn/flash_attention.py``.

* ``flash_attention_qkv`` (v2, every model path): the packed qkv projection (B, N, 3*H*Dh) in,
  (B, N, H*Dh) out; the Pallas kernels ``_fwd_qkv_kernel`` and ``_bwd_qkv_kernel`` behind the
  custom VJP ``_flash_qkv``; here ``csrc/flash_attention_qkv_fwd.cu`` and ``_bwd.cu``.
* ``flash_attention`` (v1, the attention-layer bench): q, k, v (B, N, H, Dh) in and out, split
  into heads through device memory as JAX's ``collapse`` does; the Pallas kernels ``_fwd_kernel``
  and ``_bwd_kernel`` behind ``_flash``; here ``csrc/flash_attention_fwd.cu`` and ``_bwd.cu``.

Both pairs compute one function and share their kernel bodies, all on the tensor cores (bf16:
``csrc/flash_attention_fwd_mma.cuh`` and ``csrc/flash_attention_bwd_mma.cuh``; f32 in 3xTF32,
each operand split into two TF32 terms: ``csrc/flash_attention_fwd_tf32.cuh`` and
``csrc/flash_attention_bwd_tf32.cuh``), which take heads of any length (a head too long
for shared memory streams through it in tiles). So the split-head interface is the packed one
with batch B*H and one head: its plain versions are the packed ones on ``cat([q, k, v], -1)``,
and so are its tolerances. Each interface routes through one ``torch.autograd.Function`` on every device: on a
CUDA tensor it launches the kernels or raises; on a CPU tensor it runs the plain versions
(:func:`flash_attention_qkv_reference`, :func:`flash_attention_qkv_bwd_reference` and their v1
counterparts), the same arithmetic in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from ..kernels import BWD_BODY_LAUNCHES, FWD_BODY_LAUNCHES, LAUNCHES, MASKED_LAUNCHES
from ..kernels.build import load_library

KERNEL = "flash_attention_qkv_fwd"
BWD_KERNEL = "flash_attention_qkv_bwd"
V1_KERNEL = "flash_attention_fwd"
V1_BWD_KERNEL = "flash_attention_bwd"
MAX_HEAD_DIM = 128
BODIES = ("tf32x3", "tensor_core")  # f32, bf16: indexed by the C entry points' *_fwd_body and *_bwd_body
BWD_F32_TOL = 2e-5  # see flash_attention_qkv_bwd_tolerance


def _key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """(B, N) bool, True = attend -> f32 additive key bias, 0 or -1e30."""
    zero = torch.zeros((), dtype=torch.float32, device=key_mask.device)
    return torch.where(key_mask, zero, torch.full_like(zero, -1e30))


def _split_heads(x: torch.Tensor, num_heads: int, parts: int) -> torch.Tensor:
    """(B, N, parts*H*Dh) -> (parts, B, H, N, Dh) in f32."""
    b, n, w = x.shape
    return x.reshape(b, n, parts, num_heads, w // (parts * num_heads)).permute(2, 0, 3, 1, 4).float()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, Dh) -> (B, N, H*Dh)."""
    b, h, n, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * dh)


def _probabilities(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Unrounded f32 softmax(Q K^T * scale + bias) over keys, as e / sum(e)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _fwd_plain(qkv: torch.Tensor, num_heads: int, bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    q, k, v = _split_heads(qkv, num_heads, 3)
    a = _probabilities(q, k, bias, scale).to(qkv.dtype).float()
    return _merge_heads(torch.matmul(a, v)).to(qkv.dtype)


def _bwd_plain(
    qkv: torch.Tensor, g: torch.Tensor, num_heads: int, bias: torch.Tensor | None, scale: float, magnitude: bool = False
) -> torch.Tensor:
    """The TPU kernel's backward in f32, result in the input dtype. With ``magnitude`` it returns,
    in f32, the same sums taken over the absolute values of their terms (|q|, |k|, |v|, |g|, and
    A (|dA| + D) in place of A (dA - D)): the scale of the terms each output sums."""
    q, k, v = _split_heads(qkv, num_heads, 3)
    go = _split_heads(g, num_heads, 1)[0]
    a = _probabilities(q, k, bias, scale)
    if magnitude:
        q, k, v, go = q.abs(), k.abs(), v.abs(), go.abs()
    dv = torch.matmul(a.transpose(-1, -2), go)
    da = torch.matmul(go, v.transpose(-1, -2))
    d = (da * a).sum(dim=-1, keepdim=True)
    ds = a * (da + d if magnitude else da - d) * scale
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    out = torch.cat([_merge_heads(dq), _merge_heads(dk), _merge_heads(dv)], dim=-1)
    return out if magnitude else out.to(qkv.dtype)


def _default_scale(qkv: torch.Tensor, num_heads: int, scale: float | None) -> float:
    return (qkv.shape[-1] // (3 * num_heads)) ** -0.5 if scale is None else scale


def _mask_bias(key_mask: torch.Tensor | None) -> torch.Tensor | None:
    return None if key_mask is None else _key_bias(key_mask)


def flash_attention_qkv_reference(
    qkv: torch.Tensor, num_heads: int, *, key_mask: torch.Tensor | None = None, scale: float | None = None
) -> torch.Tensor:
    """Plain version: (B, N, 3*H*Dh) -> (B, N, H*Dh).

    Scores, max, exp and sum in f32; the probabilities rounded to the input dtype before A.V,
    which sums in f32; the result rounded to the input dtype."""
    return _fwd_plain(qkv, num_heads, _mask_bias(key_mask), _default_scale(qkv, num_heads, scale))


def flash_attention_qkv_bwd_reference(
    qkv: torch.Tensor, g: torch.Tensor, num_heads: int, *, key_mask: torch.Tensor | None = None, scale: float | None = None
) -> torch.Tensor:
    """Plain backward: the packed dqkv (B, N, 3*H*Dh) = [dq | dk | dv] for the cotangent ``g``
    (B, N, H*Dh), as ``_bwd_qkv_kernel`` computes it.

    This is not autograd of :func:`flash_attention_qkv_reference`: the forward rounds A to the
    input type before A.V, while the backward recomputes A in f32 and uses it unrounded for
    dV = A^T g and dS = A o (dA - rowsum(dA o A)) * scale. Every product is in f32; dq, dk and dv
    are each rounded once to the input type. A fully masked row has a uniform A."""
    return _bwd_plain(qkv, g, num_heads, _mask_bias(key_mask), _default_scale(qkv, num_heads, scale))


def flash_attention_qkv_tolerance(
    qkv: torch.Tensor, num_heads: int, ref: torch.Tensor, *, key_mask: torch.Tensor | None = None, scale: float | None = None
) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for ``qkv``, given the plain result ``ref`` (f32).

    float32: 1e-5. The plain version forms f32 products; the kernel forms each from two TF32 terms
    per operand (3xTF32: lo hi + hi lo + hi hi, each exact, the dropped lo lo below 2^-22 of the
    product), so a product errs by about 2^-21 of its size where f32 errs by 2^-24, and the tensor
    cores sum in their own order and rounding. Emulated on the CPU
    (``tests/test_torch_attention_f32_mma.py``) the split forward reaches err/tol 0.12 at the SSL
    shapes, against 47-97 for one TF32 product; on the H100 the kernel reaches 0.33
    (``compare_kernels``), the rest being the tensor cores' own sums, each over one chunk of 16
    keys. Lower precision: the two agree to ~1e-6 relative in f32, then each rounds twice to the
    input type, and either rounding can land them on adjacent values. Rounding the output costs at
    most one ulp of |ref|. Rounding a probability p_j costs at most one ulp of p_j, at most eps *
    p_j, so at most eps * sum_j p_j |v_j| on an output: the plain version run with |v|. The second
    term keeps outputs near 0, whose ulp is tiny, inside the bound."""
    if qkv.dtype == torch.float32:
        return torch.full(ref.shape, 1e-5, device=ref.device)
    eps = torch.finfo(qkv.dtype).eps
    hd = qkv.shape[-1] // 3
    abs_v = torch.cat([qkv[..., : 2 * hd], qkv[..., 2 * hd :].abs()], dim=-1)
    pv = flash_attention_qkv_reference(abs_v, num_heads, key_mask=key_mask, scale=scale).float()
    return _ulp(ref, eps) + eps * pv + 1e-6


def flash_attention_qkv_bwd_tolerance(
    qkv: torch.Tensor, g: torch.Tensor, num_heads: int, ref: torch.Tensor, *,
    key_mask: torch.Tensor | None = None, scale: float | None = None,
) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for the backward, given the plain dqkv ``ref``.

    Both compute the same exp and division and sum in f32 in different orders. The kernel forms each
    f32 product from two TF32 terms per operand (3xTF32, about 2^-21 of the product), and a bf16
    product from the exact bf16 inputs with A and dS as two bf16 terms. An f32 sum of m terms is
    within m * eps32/2 * sum|terms| of the exact sum, and each output here sums at most N + Dh + a
    few terms along its chain (N for the sums over keys or queries, Dh for the scores and dA that
    feed them), so two such implementations differ by at most (N + Dh + 8) * eps32 * M, where M is
    the same sums over |terms| (``_bwd_plain`` with ``magnitude``). That worst case is loose:
    against float64 at the checked shapes the plain f32 backward errs by at most ~1.5e-6
    (``tests/test_torch_flash_attention.py`` holds it under ``BWD_F32_TOL / 8``), so float32 gets
    the absolute ``BWD_F32_TOL`` = 2e-5. The split products stay inside it: emulated on the CPU
    (``tests/test_torch_attention_f32_mma.py``) the f32 backward reaches err/tol 0.11 at the SSL
    shapes, against 22-101 for one TF32 product, and the kernel 0.25 on the H100 with random key
    masks and 0.38 under DINO's block masks (where |dV| reaches 13: a few kept keys take all the
    attention), once each step of its sums over keys or queries adds in f32. Lower precision:
    one ulp of |ref|, for the final rounding that can land the two on adjacent values, plus the
    worst-case f32 term. That term matters near zero: dS = A o (dA - D) cancels, so an output can be
    far smaller than the terms it sums, and a pure ulp-of-output bound would fail there."""
    if qkv.dtype == torch.float32:
        return torch.full(ref.shape, BWD_F32_TOL, device=ref.device)
    n, dh = qkv.shape[1], qkv.shape[-1] // (3 * num_heads)
    mag = _bwd_plain(qkv, g, num_heads, _mask_bias(key_mask), _default_scale(qkv, num_heads, scale), magnitude=True)
    return _ulp(ref, torch.finfo(qkv.dtype).eps) + (n + dh + 8) * torch.finfo(torch.float32).eps * mag


def _ulp(ref: torch.Tensor, eps: float) -> torch.Tensor:
    """One ulp of |ref| in a type with machine epsilon ``eps``."""
    mag = ref.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag))) * eps


_SIGNATURES = {
    "m3l_flash_qkv_fwd_body": ([ctypes.c_int], ctypes.c_int),
    "m3l_flash_qkv_fwd": (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_BWD_SIGNATURES = {
    "m3l_flash_qkv_bwd_body": ([ctypes.c_int], ctypes.c_int),
    "m3l_flash_qkv_bwd_scratch_floats": ([ctypes.c_int] * 5, ctypes.c_size_t),
    "m3l_flash_qkv_bwd": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def _check(qkv: torch.Tensor, num_heads: int) -> int:
    """Shape, dtype and layout checks both kernels share; returns head_dim."""
    b, n, thd = qkv.shape
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention_qkv: dtype {qkv.dtype} not supported (bfloat16 or float32)")
    if thd % (3 * num_heads):
        raise ValueError(f"flash_attention_qkv: last dim {thd} is not 3 * heads({num_heads}) * head_dim")
    dh = thd // (3 * num_heads)
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_qkv: head_dim {dh} must be a multiple of 8 and at most {MAX_HEAD_DIM}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_qkv: qkv must be contiguous and 16-byte aligned")
    if b > 65535 or num_heads > 65535:
        raise ValueError(f"flash_attention_qkv: batch {b} and heads {num_heads} must each be at most 65535")
    return dh


def _launch(qkv: torch.Tensor, num_heads: int, bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """The forward kernel on ``qkv``, by the body the C side's rule picks (bf16 or f32 in
    3xTF32); ``bias`` is the contiguous f32 (B, N) key bias or None."""
    b, n, thd = qkv.shape
    dh = _check(qkv, num_heads)
    lib = load_library(KERNEL, _SIGNATURES)
    body = BODIES[lib.m3l_flash_qkv_fwd_body(qkv.element_size())]
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
    FWD_BODY_LAUNCHES[body] += 1
    if bias is not None:
        MASKED_LAUNCHES[KERNEL] += 1
    return out


def _bwd_scratch(floats: int, device) -> torch.Tensor | None:
    """The f32 scratch of row statistics a backward launch needs, as the C side sizes it (None: none)."""
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def _launch_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """The backward kernel: packed dqkv for the cotangent ``g``, by the body the C side's rule
    picks (bf16 or f32 in 3xTF32)."""
    b, n, thd = qkv.shape
    dh = _check(qkv, num_heads)
    if g.shape != (b, n, thd // 3) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(f"flash_attention_qkv backward: cotangent must be {qkv.dtype} ({b}, {n}, {thd // 3}) on {qkv.device}")
    g = g.contiguous()  # an expanded or strided cotangent is copied, not refused
    if g.data_ptr() % 16:
        raise ValueError("flash_attention_qkv backward: cotangent must be 16-byte aligned")
    lib = load_library(BWD_KERNEL, _BWD_SIGNATURES)
    body = BODIES[lib.m3l_flash_qkv_bwd_body(qkv.element_size())]
    dqkv = torch.empty_like(qkv)
    stats = _bwd_scratch(lib.m3l_flash_qkv_bwd_scratch_floats(b, n, num_heads, dh, qkv.element_size()), qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.m3l_flash_qkv_bwd(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
            None if stats is None else stats.data_ptr(), b, n, num_heads, dh, float(scale), qkv.element_size(), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_qkv backward: kernel launch failed with CUDA error {err}")
    LAUNCHES[BWD_KERNEL] += 1
    BWD_BODY_LAUNCHES[body] += 1
    if bias is not None:
        MASKED_LAUNCHES[BWD_KERNEL] += 1
    return dqkv


class _FlashQKV(torch.autograd.Function):
    """Forward and backward of the packed attention; saves ``qkv`` and the key bias, as the
    TPU custom VJP ``_flash_qkv_fwd`` does. The bias gets no gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, scale):
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads, ctx.scale = num_heads, scale
        if qkv.device.type == "cuda":
            return _launch(qkv, num_heads, bias, scale)
        return _fwd_plain(qkv, num_heads, bias, scale)

    @staticmethod
    def backward(ctx, g):
        qkv, bias = ctx.saved_tensors
        if qkv.device.type == "cuda":
            dqkv = _launch_bwd(qkv, g, ctx.num_heads, bias, ctx.scale)
        else:
            dqkv = _bwd_plain(qkv, g, ctx.num_heads, bias, ctx.scale)
        return dqkv, None, None, None


def flash_attention_qkv(
    qkv: torch.Tensor, num_heads: int, *, key_mask: torch.Tensor | None = None, scale: float | None = None
) -> torch.Tensor:
    """Fused attention on the packed qkv tensor (B, N, 3*H*Dh) -> (B, N, H*Dh), differentiable
    with respect to ``qkv``."""
    if qkv.dim() != 3:
        raise ValueError(f"flash_attention_qkv: qkv must be (B, N, 3*H*Dh), got {tuple(qkv.shape)}")
    if qkv.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention_qkv: no kernel for device {qkv.device}")
    bias = None
    if key_mask is not None:
        b, n = qkv.shape[:2]
        if key_mask.shape != (b, n) or key_mask.dtype != torch.bool or key_mask.device != qkv.device:
            raise ValueError(f"flash_attention_qkv: key_mask must be bool ({b}, {n}) on {qkv.device}")
        bias = _key_bias(key_mask).contiguous()
    return _FlashQKV.apply(qkv, bias, num_heads, float(_default_scale(qkv, num_heads, scale)))


# --------------------------------------------------------------------------------------------- #
# v1: split heads, q, k, v (B, N, H, Dh). In the kernels' terms this is batch B*H with one head:
# q, k, v collapsed to (B*H, N, Dh) and the key bias repeated per head, row b*H + h.
# --------------------------------------------------------------------------------------------- #


def _collapse(x: torch.Tensor) -> torch.Tensor:
    """(B, N, H, Dh) -> contiguous (B*H, N, Dh), row b*H + h (JAX's ``collapse``)."""
    b, n, h, dh = x.shape
    return x.transpose(1, 2).reshape(b * h, n, dh).contiguous()


def _uncollapse(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B*H, N, Dh) -> (B, N, H, Dh)."""
    bh, n, dh = x.shape
    return x.reshape(bh // heads, heads, n, dh).transpose(1, 2)


def _v1_mask(key_mask: torch.Tensor | None, heads: int) -> torch.Tensor | None:
    """(B, N) key mask -> (B*H, N), row b*H + h (``jnp.repeat(..., h, axis=0)``)."""
    return None if key_mask is None else key_mask.repeat_interleave(heads, 0)


def _v1_fwd_plain(q, k, v, bias, scale) -> torch.Tensor:
    """The packed plain forward with one head on (B*H, N, 3*Dh)."""
    return _fwd_plain(torch.cat([q, k, v], dim=-1), 1, bias, scale)


def _v1_bwd_plain(q, k, v, g, bias, scale) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The packed plain backward with one head, split into (dq, dk, dv)."""
    return _bwd_plain(torch.cat([q, k, v], dim=-1), g, 1, bias, scale).chunk(3, dim=-1)


def _v1_scale(q: torch.Tensor, scale: float | None) -> float:
    return q.shape[-1] ** -0.5 if scale is None else scale


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, key_mask: torch.Tensor | None = None, scale: float | None = None
) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: (B, N, H, Dh) -> (B, N, H, Dh), the arithmetic
    of :func:`flash_attention_qkv_reference`."""
    h = q.shape[2]
    out = _v1_fwd_plain(_collapse(q), _collapse(k), _collapse(v), _mask_bias(_v1_mask(key_mask, h)), _v1_scale(q, scale))
    return _uncollapse(out, h)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *,
    key_mask: torch.Tensor | None = None, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of :func:`flash_attention` for the cotangent ``g`` (B, N, H, Dh): (dq, dk,
    dv), each (B, N, H, Dh), as ``_bwd_kernel`` computes them (the arithmetic of
    :func:`flash_attention_qkv_bwd_reference`)."""
    h = q.shape[2]
    bias = _mask_bias(_v1_mask(key_mask, h))
    grads = _v1_bwd_plain(_collapse(q), _collapse(k), _collapse(v), _collapse(g), bias, _v1_scale(q, scale))
    return tuple(_uncollapse(x, h) for x in grads)


def flash_attention_tolerance(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ref: torch.Tensor, *,
    key_mask: torch.Tensor | None = None, scale: float | None = None,
) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for :func:`flash_attention`: the bound of
    :func:`flash_attention_qkv_tolerance` on the same numbers, packed with one head."""
    h = q.shape[2]
    qkv = torch.cat([_collapse(q), _collapse(k), _collapse(v)], dim=-1)
    tol = flash_attention_qkv_tolerance(qkv, 1, _collapse(ref), key_mask=_v1_mask(key_mask, h), scale=_v1_scale(q, scale))
    return _uncollapse(tol, h)


def flash_attention_bwd_tolerance(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, refs: tuple, *,
    key_mask: torch.Tensor | None = None, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Elementwise bounds on |kernel - plain| for (dq, dk, dv), given the plain ``refs``: the
    bound of :func:`flash_attention_qkv_bwd_tolerance` on the same numbers, packed with one head."""
    h = q.shape[2]
    qkv = torch.cat([_collapse(q), _collapse(k), _collapse(v)], dim=-1)
    ref = torch.cat([_collapse(r) for r in refs], dim=-1)
    tol = flash_attention_qkv_bwd_tolerance(qkv, _collapse(g), 1, ref, key_mask=_v1_mask(key_mask, h), scale=_v1_scale(q, scale))
    return tuple(_uncollapse(t, h) for t in tol.chunk(3, dim=-1))


_V1_SIGNATURES = {
    "m3l_flash_fwd_body": ([ctypes.c_int], ctypes.c_int),
    "m3l_flash_fwd": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}
_V1_BWD_SIGNATURES = {
    "m3l_flash_bwd_body": ([ctypes.c_int], ctypes.c_int),
    "m3l_flash_bwd_scratch_floats": ([ctypes.c_int] * 4, ctypes.c_size_t),
    "m3l_flash_bwd": (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
}


def _check_v1(q: torch.Tensor, *others: torch.Tensor) -> int:
    """Checks both split-head kernels share, on q and the tensors of its shape; returns head_dim."""
    bh, n, dh = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported (bfloat16 or float32)")
    if dh % 8 or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {dh} must be a multiple of 8 and at most {MAX_HEAD_DIM}")
    for t in (q, *others):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: every operand must be {q.dtype} {tuple(q.shape)} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash_attention: operands must be contiguous and 16-byte aligned")
    if bh > 65535:
        raise ValueError(f"flash_attention: batch * heads {bh} must be at most 65535")
    return dh


def _launch_v1(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """The split-head forward kernel on (B*H, N, Dh) operands, by the packed forward's bodies
    and rule; ``bias`` is the contiguous f32 (B*H, N) key bias or None."""
    bh, n, _ = q.shape
    dh = _check_v1(q, k, v)
    lib = load_library(V1_KERNEL, _V1_SIGNATURES)
    body = BODIES[lib.m3l_flash_fwd_body(q.element_size())]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.m3l_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            bh, n, dh, float(scale), q.element_size(), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    LAUNCHES[V1_KERNEL] += 1
    FWD_BODY_LAUNCHES[body] += 1
    return out


def _launch_v1_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, bias: torch.Tensor | None, scale: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split-head backward kernel: (dq, dk, dv) for the cotangent ``g``, by the packed
    backward's bodies and rule."""
    bh, n, _ = q.shape
    g = g.contiguous()  # an expanded or strided cotangent is copied, not refused
    dh = _check_v1(q, k, v, g)
    lib = load_library(V1_BWD_KERNEL, _V1_BWD_SIGNATURES)
    body = BODIES[lib.m3l_flash_bwd_body(q.element_size())]
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = _bwd_scratch(lib.m3l_flash_bwd_scratch_floats(bh, n, dh, q.element_size()), q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.m3l_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(), g.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), None if stats is None else stats.data_ptr(),
            bh, n, dh, float(scale), q.element_size(), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention backward: kernel launch failed with CUDA error {err}")
    LAUNCHES[V1_BWD_KERNEL] += 1
    BWD_BODY_LAUNCHES[body] += 1
    return dq, dk, dv


class _FlashV1(torch.autograd.Function):
    """Forward and backward of the split-head attention on collapsed (B*H, N, Dh) operands; saves
    q, k, v and the key bias, as the TPU custom VJP ``_flash_fwd`` does. The bias gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        if q.device.type == "cuda":
            return _launch_v1(q, k, v, bias, scale)
        return _v1_fwd_plain(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        if q.device.type == "cuda":
            dq, dk, dv = _launch_v1_bwd(q, k, v, g, bias, ctx.scale)
        else:
            dq, dk, dv = _v1_bwd_plain(q, k, v, g, bias, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, key_mask: torch.Tensor | None = None, scale: float | None = None
) -> torch.Tensor:
    """Fused multi-head attention, (B, N, H, Dh) -> (B, N, H, Dh), differentiable with respect to
    q, k and v. Each operand is split into heads in device memory (``transpose(1, 2)``, a copy)
    before the kernel and the output merged after it, as the JAX v1 interface does."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one (B, N, H, Dh) shape, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, n, h, _ = q.shape
    bias = None
    if key_mask is not None:
        if key_mask.shape != (b, n) or key_mask.dtype != torch.bool or key_mask.device != q.device:
            raise ValueError(f"flash_attention: key_mask must be bool ({b}, {n}) on {q.device}")
        bias = _key_bias(_v1_mask(key_mask, h)).contiguous()
    out = _FlashV1.apply(_collapse(q), _collapse(k), _collapse(v), bias, float(_v1_scale(q, scale)))
    return _uncollapse(out, h)
