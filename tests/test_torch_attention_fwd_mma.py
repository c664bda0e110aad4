"""The arithmetic of the bf16 tensor-core attention forward, emulated on the CPU.

``csrc/flash_attention_fwd_mma.cuh`` computes S = Q K^T as exact bf16 products with f32 sums,
scales it with one fma (``fmaf(s, scale, bias)``), and sweeps the keys once, 16 at a time (keys
past N padded with zeros and the bias -inf): an online row max m and sum l in f32, the
unnormalised e = exp(s - m) rounded once to bf16 for O += e V (exact products, f32 sums), O and
l rescaled by exp(m_old - m_new) when the max grows, and O times 1 / l rounded once to bf16 at
the end. ``_emulated_fwd`` does the same in plain PyTorch (a test helper; nothing on the main
path calls it). It must stay within the unchanged bound the kernel is held to on the card,
``flash_attention_qkv_tolerance`` of ``flash_attention_qkv_reference``, which rounds the
normalised A instead; leaving out the last, ragged key chunk must not, so the bound tells a right
kernel from a wrong one. Inputs come from numpy with a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3l_tpu.nn.flash_attention import flash_attention_qkv as jax_flash_attention_qkv
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.nn.flash_attention import flash_attention_qkv_reference, flash_attention_qkv_tolerance

SHAPES = [(4, 10, 4, 64), (4, 192, 4, 64), (2, 33, 2, 128), (3, 1, 2, 8), (8, 196, 16, 64)]
CHUNK = 16


def _emulated_fwd(qkv, num_heads, key_mask=None, drop_last_chunk=False):
    """The kernel's forward on bf16 ``qkv`` (B, N, 3*H*Dh) -> bf16 (B, N, H*Dh)."""
    scale = torch.tensor(fa._default_scale(qkv, num_heads, None), dtype=torch.float32).double()
    q, k, v = fa._split_heads(qkv, num_heads, 3)  # f32 (B, H, N, Dh), each value a bf16
    b, n = qkv.shape[:2]
    pad = -n % CHUNK
    bias = torch.zeros(b, n) if key_mask is None else fa._key_bias(key_mask)
    bias = torch.cat([bias, torch.full((b, pad), -torch.inf)], dim=1)
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    # fmaf(s, scale, bias): the exact product plus the bias, rounded once to f32
    s_all = (torch.matmul(q, k.transpose(-1, -2)).double() * scale + bias.double()[:, None, None, :]).float()
    m = torch.full(q.shape[:-1], -torch.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    stop = n + pad - (CHUNK if drop_last_chunk else 0)
    for j0 in range(0, stop, CHUNK):
        s = s_all[..., j0 : j0 + CHUNK]
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)  # 0 on the first chunk, whose key 0 is real
        m = m_new
        e = torch.exp(s - m[..., None])
        l = l * corr + e.sum(dim=-1)
        o = o * corr[..., None] + torch.matmul(e.bfloat16().float(), v[..., j0 : j0 + CHUNK, :])
    o = o * (1.0 / l)[..., None]
    return fa._merge_heads(o).to(qkv.dtype)


def _inputs(b, n, h, dh, masked, seed=0):
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(b, n, 3 * h * dh)).astype(np.float32)).bfloat16()
    mask = None
    if masked:
        mask = torch.from_numpy(rng.uniform(size=(b, n)) > 0.3)
        mask[:, 0] = True
    return qkv, mask


def _err_over_tol(qkv, h, mask, out, ref=None) -> float:
    """max |out - ref| / bound; NaN counts as out of bound."""
    ref = flash_attention_qkv_reference(qkv, h, key_mask=mask) if ref is None else ref
    tol = flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)
    return torch.nan_to_num((out.float() - ref.float()).abs() / tol, nan=torch.inf).max().item()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,h,dh", SHAPES)
def test_one_pass_within_the_kernel_bound(b, n, h, dh, masked):
    qkv, mask = _inputs(b, n, h, dh, masked)
    out = _emulated_fwd(qkv, h, mask)
    assert out.dtype == torch.bfloat16 and out.shape == (b, n, h * dh) and torch.isfinite(out).all()
    assert _err_over_tol(qkv, h, mask, out) <= 1.0


@pytest.mark.parametrize("n", [10, 40])
def test_one_pass_with_a_fully_masked_row(n):
    qkv, mask = _inputs(3, n, 2, 64, True, seed=1)
    mask[1] = False  # row 1 attends uniformly over its n keys
    out = _emulated_fwd(qkv, 2, mask)
    v = qkv[1, :, 2 * 128 :].float().reshape(n, 2, 64)
    assert torch.allclose(out[1].float().reshape(n, 2, 64), v.mean(dim=0).expand(n, 2, 64), atol=2e-2)
    assert _err_over_tol(qkv, 2, mask, out) <= 1.0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,n,h,dh", [s for s in SHAPES if s[1] % CHUNK and s[1] > CHUNK])
def test_dropping_the_last_ragged_chunk_exceeds_the_kernel_bound(b, n, h, dh, masked):
    qkv, mask = _inputs(b, n, h, dh, masked)
    assert _err_over_tol(qkv, h, mask, _emulated_fwd(qkv, h, mask, drop_last_chunk=True)) > 1.0


@pytest.mark.parametrize("masked", [False, True])
def test_one_pass_against_jax_interpret(masked):
    """The emulated kernel against the Pallas ``_fwd_qkv_kernel`` in interpret mode, bf16, within
    the same bound (JAX's bf16 output as the reference)."""
    b, n, h, dh = 2, 33, 2, 64
    qkv, mask = _inputs(b, n, h, dh, masked, seed=2)
    jmask = None if mask is None else jnp.asarray(mask.numpy())
    jout = jax_flash_attention_qkv(jnp.asarray(qkv.float().numpy(), jnp.bfloat16), h, key_mask=jmask, interpret=True)
    ref = torch.from_numpy(np.array(jout.astype(jnp.float32)))
    assert _err_over_tol(qkv, h, mask, _emulated_fwd(qkv, h, mask), ref=ref) <= 1.0
