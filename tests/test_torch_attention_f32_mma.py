"""The arithmetic of the f32 attention bodies on the tensor cores ("3xTF32"), emulated on the CPU.

``csrc/flash_attention_fwd_tf32.cuh`` and ``csrc/flash_attention_bwd_tf32.cuh`` run every f32
product as TF32 tensor-core products: each operand x is split into hi = tf32(x) and
lo = tf32(x - hi), rounded to nearest with ties away (``cvt.rna.tf32.f32``), and each product is
lo hi + hi lo + hi hi into one f32 accumulator (lo lo dropped). TF32 keeps 11 significant bits,
so each of those products is exact in f32. ``_tf32`` rounds by bit operations on the int32 view;
``_mm`` forms the three products, each an exact product summed in f32. The forward sweeps the
keys once, 16 at a time, with an online row max and sum (the unnormalised e = exp(s - m) in
e V, O times 1 / l at the end); the backward forms S, dA, D, dS and dQ, dK, dV from the split
products. These are test helpers; nothing on the main path calls them.

The emulated bodies must stay within the unchanged bounds the kernels are held to on the card,
``flash_attention_qkv_tolerance`` (f32 1e-5) and ``flash_attention_qkv_bwd_tolerance`` (f32
``BWD_F32_TOL``) of the plain versions, and within the same bounds of JAX's
``flash_attention_qkv`` run as its own tests run it (``interpret=True``); one TF32 product (hi
hi only) must not, so the bounds tell the designs apart. Inputs come from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3l_tpu.nn.flash_attention import flash_attention_qkv as jax_flash_attention_qkv
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.nn.flash_attention import (
    flash_attention_qkv_bwd_reference,
    flash_attention_qkv_bwd_tolerance,
    flash_attention_qkv_reference,
    flash_attention_qkv_tolerance,
)
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (B, N, H, Dh): the SSL encoder at full image and masked, the He-style decoder, one key, a wide
# ragged head, and a head past both f32 bodies' whole-head limits (streamed on the card: N > 416
# forward and N > 400 backward at Dh = 64)
SHAPES = [(2, 196, 6, 64), (2, 196, 16, 32), (2, 49, 6, 64), (3, 1, 2, 8), (2, 33, 2, 128), (1, 420, 2, 64)]
CHUNK = 16


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to the nearest TF32 value (10 mantissa bits), ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(x)
    return hi, _tf32(x - hi)  # x - hi is exact in f32


def _mm(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b as the kernels form it: three TF32 products of the split operands (lo hi, hi lo,
    hi hi), each exact and summed in f32; ``terms=1`` keeps hi hi only."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if terms == 1:
        return torch.matmul(ah, bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def _scores(q, k, bias, scale, terms):
    """fmaf(Q K^T, scale, bias): the exact product plus the bias, rounded once to f32."""
    s = _mm(q, k.transpose(-1, -2), terms).double() * scale
    return (s + bias.double()[:, None, None, :]).float()


def _emulated_fwd(qkv, num_heads, key_mask=None, terms=3):
    """The f32 forward body on ``qkv`` (B, N, 3*H*Dh) -> (B, N, H*Dh)."""
    scale = torch.tensor(fa._default_scale(qkv, num_heads, None), dtype=torch.float32).double()
    q, k, v = fa._split_heads(qkv, num_heads, 3)
    b, n = qkv.shape[:2]
    pad = -n % CHUNK
    bias = torch.zeros(b, n) if key_mask is None else fa._key_bias(key_mask)
    bias = torch.cat([bias, torch.full((b, pad), -torch.inf)], dim=1)
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    s_all = _scores(q, k, bias, scale, terms)
    m = torch.full(q.shape[:-1], -torch.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    for j0 in range(0, n + pad, CHUNK):
        s = s_all[..., j0 : j0 + CHUNK]
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)  # 0 on the first chunk, whose key 0 is real
        m = m_new
        e = torch.exp(s - m[..., None])
        l = l * corr + e.sum(dim=-1)
        o = o * corr[..., None] + _mm(e, v[..., j0 : j0 + CHUNK, :], terms)
    return fa._merge_heads(o * (1.0 / l)[..., None])


def _emulated_bwd(qkv, g, num_heads, key_mask=None, terms=3):
    """The f32 backward body: packed dqkv for the cotangent ``g``."""
    scale = fa._default_scale(qkv, num_heads, None)
    q, k, v = fa._split_heads(qkv, num_heads, 3)
    go = fa._split_heads(g, num_heads, 1)[0]
    b, n = qkv.shape[:2]
    bias = torch.zeros(b, n) if key_mask is None else fa._key_bias(key_mask)
    s = _scores(q, k, bias, torch.tensor(scale, dtype=torch.float32).double(), terms)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    linv = 1.0 / e.sum(dim=-1, keepdim=True)
    a = e * linv
    da = _mm(go, v.transpose(-1, -2), terms)
    d = (e * da).sum(dim=-1, keepdim=True) * linv
    ds = (a * (da - d)) * scale
    dq = _mm(ds, k, terms)
    dk = _mm(ds.transpose(-1, -2), q, terms)
    dv = _mm(a.transpose(-1, -2), go, terms)
    return torch.cat([fa._merge_heads(x) for x in (dq, dk, dv)], dim=-1)


def _inputs(b, n, h, dh, masked, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * dh)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype(np.float32))
    mask = None
    if masked:
        mask = torch.from_numpy(rng.uniform(size=(b, n)) > 0.3)
        mask[:, 0] = True
    return qkv, g, mask


def _fwd_err_over_tol(qkv, h, mask, out, ref=None) -> float:
    """max |out - ref| / bound; NaN counts as out of bound."""
    ref = flash_attention_qkv_reference(qkv, h, key_mask=mask) if ref is None else ref
    tol = flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)
    return torch.nan_to_num((out - ref).abs() / tol, nan=torch.inf).max().item()


def _bwd_err_over_tol(qkv, g, h, mask, out, ref=None) -> float:
    ref = flash_attention_qkv_bwd_reference(qkv, g, h, key_mask=mask) if ref is None else ref
    tol = flash_attention_qkv_bwd_tolerance(qkv, g, h, ref, key_mask=mask)
    return torch.nan_to_num((out - ref).abs() / tol, nan=torch.inf).max().item()


def _jax(qkv, g, h, mask):
    """JAX's flash_attention_qkv in interpret mode, f32: the output and the gradient of <out, g>."""
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    out, vjp = jax.vjp(lambda x: jax_flash_attention_qkv(x, h, key_mask=jmask, interpret=True), jnp.asarray(qkv.numpy()))
    (grad,) = vjp(jnp.asarray(g.numpy()))
    return torch.from_numpy(np.array(out)), torch.from_numpy(np.array(grad))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,h,dh", SHAPES)
def test_three_term_forward_within_the_kernel_bound(b, n, h, dh, masked):
    qkv, _, mask = _inputs(b, n, h, dh, masked)
    out = _emulated_fwd(qkv, h, mask)
    assert out.dtype == torch.float32 and out.shape == (b, n, h * dh) and torch.isfinite(out).all()
    assert _fwd_err_over_tol(qkv, h, mask, out) <= 1.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,h,dh", SHAPES)
def test_three_term_backward_within_the_kernel_bound(b, n, h, dh, masked):
    qkv, g, mask = _inputs(b, n, h, dh, masked)
    out = _emulated_bwd(qkv, g, h, mask)
    assert out.dtype == torch.float32 and out.shape == qkv.shape and torch.isfinite(out).all()
    assert _bwd_err_over_tol(qkv, g, h, mask, out) <= 1.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,h,dh", SHAPES)
def test_three_term_against_jax_interpret(b, n, h, dh, masked):
    """The emulated bodies against the Pallas ``_fwd_qkv_kernel`` and ``_bwd_qkv_kernel`` in
    interpret mode, f32, within the same bounds (JAX's output and gradient as the reference)."""
    qkv, g, mask = _inputs(b, n, h, dh, masked, seed=3)
    out, grad = _jax(qkv, g, h, mask)
    assert _fwd_err_over_tol(qkv, h, mask, _emulated_fwd(qkv, h, mask), ref=out) <= 1.0
    assert _bwd_err_over_tol(qkv, g, h, mask, _emulated_bwd(qkv, g, h, mask), ref=grad) <= 1.0


@pytest.mark.parametrize("n", [10, 40])
def test_three_term_with_a_fully_masked_row(n):
    qkv, g, mask = _inputs(3, n, 2, 64, True, seed=1)
    mask[1] = False  # row 1 attends uniformly over its n keys
    out = _emulated_fwd(qkv, 2, mask)
    v = qkv[1, :, 2 * 128 :].reshape(n, 2, 64)
    assert torch.allclose(out[1].reshape(n, 2, 64), v.mean(dim=0).expand(n, 2, 64), atol=1e-5)
    assert _fwd_err_over_tol(qkv, 2, mask, out) <= 1.0
    grad = _emulated_bwd(qkv, g, 2, mask)
    assert grad[1].abs().max() > 0
    assert _bwd_err_over_tol(qkv, g, 2, mask, grad) <= 1.0


@pytest.mark.parametrize("b,n,h,dh", SHAPES[:4])
def test_one_tf32_product_exceeds_the_kernel_bound(b, n, h, dh):
    qkv, g, _ = _inputs(b, n, h, dh, False)
    assert _fwd_err_over_tol(qkv, h, None, _emulated_fwd(qkv, h, terms=1)) > 1.0
    assert _bwd_err_over_tol(qkv, g, h, None, _emulated_bwd(qkv, g, h, terms=1)) > 1.0


def test_tf32_rounding_by_bits():
    """Round to nearest at the 13th bit below the mantissa's top, ties away from zero; the two
    terms hold x to 2^-22 of it."""
    ulp = 2.0**-10  # of a TF32 value in [1, 2)
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0**-23, 1.0 + 3 * ulp / 2, 0.0])
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 0.0])
    assert torch.equal(_tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(4).normal(size=10_000).astype(np.float32))
    hi, lo = _split(r)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert ((hi.double() + lo.double() - r.double()).abs() <= 2.0**-22 * r.double().abs()).all()
