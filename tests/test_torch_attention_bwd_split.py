"""The arithmetic of the bf16 tensor-core attention backward, emulated on the CPU.

``csrc/flash_attention_bwd_mma.cuh`` computes S = Q K^T and dA = g V^T as exact bf16 products
with f32 sums, and dV = A^T g, dQ = dS K and dK = dS^T Q with the f32 A and dS split into two
bf16 terms (hi = bf16(x), lo = bf16(x - hi)), each term an exact product summed in f32, each
output rounded once to bf16. ``_emulated_bwd`` does the same in plain PyTorch (a test helper;
nothing on the main path calls it). It must stay within the unchanged bound the kernel is held
to on the card, ``flash_attention_qkv_bwd_tolerance`` of ``flash_attention_qkv_bwd_reference``;
rounding A and dS once to bf16 must not, so the bound tells the two designs apart. Inputs come
from numpy with a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3l_tpu.nn.flash_attention import flash_attention_qkv as jax_flash_attention_qkv
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.nn.flash_attention import flash_attention_qkv_bwd_reference, flash_attention_qkv_bwd_tolerance

SHAPES = [(4, 10, 4, 64), (4, 192, 4, 64), (2, 33, 2, 128), (3, 1, 2, 8)]


def _terms(x: torch.Tensor, count: int) -> list[torch.Tensor]:
    """``count`` bf16 values (held in f32) whose sum is ``x`` to 8 * count bits."""
    out = []
    for _ in range(count):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]  # exact in f32
    return out


def _emulated_bwd(qkv, g, num_heads, key_mask=None, terms=2):
    """The kernel's backward: f32 A and dS as ``terms`` bf16 terms in dV, dQ and dK."""
    bias = fa._mask_bias(key_mask)
    scale = fa._default_scale(qkv, num_heads, None)
    q, k, v = fa._split_heads(qkv, num_heads, 3)
    go = fa._split_heads(g, num_heads, 1)[0]
    a = fa._probabilities(q, k, bias, scale)
    da = torch.matmul(go, v.transpose(-1, -2))
    ds = a * (da - (da * a).sum(dim=-1, keepdim=True)) * scale
    dq = sum(torch.matmul(t, k) for t in _terms(ds, terms))
    dk = sum(torch.matmul(t.transpose(-1, -2), q) for t in _terms(ds, terms))
    dv = sum(torch.matmul(t.transpose(-1, -2), go) for t in _terms(a, terms))
    return torch.cat([fa._merge_heads(x) for x in (dq, dk, dv)], dim=-1).to(qkv.dtype)


def _inputs(b, n, h, dh, masked, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * dh)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.normal(size=(b, n, h * dh)).astype(np.float32)).bfloat16()
    mask = None
    if masked:
        mask = torch.from_numpy(rng.uniform(size=(b, n)) > 0.3)
        mask[:, 0] = True
    return qkv, g, mask


def _err_over_tol(qkv, g, h, mask, out) -> float:
    ref = flash_attention_qkv_bwd_reference(qkv, g, h, key_mask=mask)
    tol = flash_attention_qkv_bwd_tolerance(qkv, g, h, ref, key_mask=mask)
    return ((out.float() - ref.float()).abs() / tol).max().item()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,h,dh", SHAPES)
def test_two_term_split_within_the_kernel_bound(b, n, h, dh, masked):
    qkv, g, mask = _inputs(b, n, h, dh, masked)
    out = _emulated_bwd(qkv, g, h, mask)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    assert _err_over_tol(qkv, g, h, mask, out) <= 1.0


def test_two_term_split_with_a_fully_masked_row():
    qkv, g, mask = _inputs(3, 10, 2, 64, True, seed=1)
    mask[1] = False  # row 1 attends uniformly over its 10 keys
    out = _emulated_bwd(qkv, g, 2, mask)
    assert out[1].float().abs().max() > 0
    assert _err_over_tol(qkv, g, 2, mask, out) <= 1.0


@pytest.mark.parametrize("b,n,h,dh", SHAPES[:3])  # at N = 1, A = 1 and dS = 0 are exact in bf16
def test_rounding_once_exceeds_the_kernel_bound(b, n, h, dh):
    qkv, g, _ = _inputs(b, n, h, dh, False)
    assert _err_over_tol(qkv, g, h, None, _emulated_bwd(qkv, g, h, terms=1)) > 1.0


def test_two_term_split_against_jax_interpret():
    """The emulated kernel against the Pallas ``_bwd_qkv_kernel`` in interpret mode, bf16, within
    the same bound (JAX's bf16 gradient as the reference)."""
    b, n, h, dh = 2, 24, 2, 32
    qkv, g, mask = _inputs(b, n, h, dh, True, seed=2)
    jq, jg = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qkv, g))
    _, vjp = jax.vjp(lambda x: jax_flash_attention_qkv(x, h, key_mask=jnp.asarray(mask.numpy()), interpret=True), jq)
    ref = torch.from_numpy(np.array(vjp(jg)[0].astype(jnp.float32)))
    out = _emulated_bwd(qkv, g, h, mask)
    tol = flash_attention_qkv_bwd_tolerance(qkv, g, h, ref, key_mask=mask)
    assert ((out.float() - ref).abs() <= tol).all()
