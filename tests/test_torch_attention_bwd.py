"""The port's plain attention backward against the JAX backward on the CPU.

The JAX side is ``jax.vjp`` through ``m3l_tpu.nn.flash_attention.flash_attention_qkv(...,
interpret=True)``, whose custom VJP runs the Pallas ``_bwd_qkv_kernel`` in interpret mode; the
port's side is ``flash_attention_qkv_bwd_reference`` and the ``autograd.Function`` behind
``flash_attention_qkv``. Inputs and cotangents come from numpy with a seed. Tolerances: f32 at
rtol/atol 1e-5 (the same f32 products in another summation order); bf16 within
``flash_attention_qkv_bwd_tolerance``, the bound the CUDA kernel is held to on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3l_tpu.nn.flash_attention import flash_attention_qkv as jax_flash_attention_qkv
from m3l_tpu_torch.kernels import build
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.nn.flash_attention import (
    BWD_F32_TOL,
    flash_attention_qkv,
    flash_attention_qkv_bwd_reference,
    flash_attention_qkv_bwd_tolerance,
)


def _inputs(b, n, h, dh, masked, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3 * h * dh)).astype(np.float32)
    g = rng.normal(size=(b, n, h * dh)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(b, n)) > 0.3
        mask[:, 0] = True  # every row keeps one key
    return qkv, g, mask


def _jax_bwd(qkv, g, h, mask, dtype=jnp.float32):
    jm = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda x: jax_flash_attention_qkv(x, h, key_mask=jm, interpret=True), jnp.asarray(qkv, dtype))
    return np.asarray(vjp(jnp.asarray(g, dtype))[0].astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h", [1, 2, 4])
@pytest.mark.parametrize("n", [10, 24])
def test_bwd_reference_matches_jax(n, h, masked):
    qkv, g, mask = _inputs(2, n, h, 16, masked)
    ref = _jax_bwd(qkv, g, h, mask)
    out = flash_attention_qkv_bwd_reference(_t(qkv), _t(g), h, key_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_fully_masked_row_gradient_like_jax():
    """A batch row with every key masked has a uniform A; its gradient flows as in JAX."""
    qkv, g, _ = _inputs(2, 10, 2, 16, False, seed=3)
    mask = np.ones((2, 10), bool)
    mask[1] = False
    ref = _jax_bwd(qkv, g, 2, mask)
    out = flash_attention_qkv_bwd_reference(_t(qkv), _t(g), 2, key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert np.abs(ref[1]).max() > 0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [10, 24])
def test_bf16_within_kernel_bwd_tolerance_of_jax(n, masked):
    """The bound the CUDA backward is held to also covers the Pallas kernel's bf16 backward, and
    is tight enough to see a dropped key."""
    qkv, g, mask = _inputs(3, n, 2, 32, masked, seed=4)
    jq = np.asarray(jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32))
    jg = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    ref = _jax_bwd(jq, jg, 2, mask, jnp.bfloat16)
    tq, tg, tm = _t(jq, torch.bfloat16), _t(jg, torch.bfloat16), None if mask is None else torch.from_numpy(mask)
    out = flash_attention_qkv_bwd_reference(tq, tg, 2, key_mask=tm)
    assert out.dtype == torch.bfloat16
    tol = flash_attention_qkv_bwd_tolerance(tq, tg, 2, out, key_mask=tm).numpy()
    assert (np.abs(out.float().numpy() - ref) <= tol).all()
    wrong = flash_attention_qkv_bwd_reference(tq[:, 1:], tg[:, 1:], 2, key_mask=None if tm is None else tm[:, 1:])
    assert (np.abs(wrong.float().numpy() - ref[:, 1:]) > tol[:, 1:]).any()


@pytest.mark.parametrize("masked", [False, True])
def test_autograd_on_cpu_gives_the_plain_backward(masked):
    qkv, g, mask = _inputs(2, 24, 4, 16, masked, seed=5)
    tm = None if mask is None else torch.from_numpy(mask)
    x = _t(qkv).requires_grad_(True)
    out = flash_attention_qkv(x, 4, key_mask=tm, scale=0.3)
    out.backward(_t(g))
    expected = flash_attention_qkv_bwd_reference(_t(qkv), _t(g), 4, key_mask=tm, scale=0.3)
    np.testing.assert_array_equal(x.grad.numpy(), expected.numpy())
    # an expanded cotangent (from sum()) is handled the same way
    x.grad = None
    flash_attention_qkv(x, 4, key_mask=tm).sum().backward()
    ones = flash_attention_qkv_bwd_reference(_t(qkv), torch.ones(2, 24, 64), 4, key_mask=tm)
    np.testing.assert_array_equal(x.grad.numpy(), ones.numpy())


def test_f32_backward_error_is_far_inside_the_f32_bound():
    """BWD_F32_TOL rests on this: the plain f32 backward against the same arithmetic in f64, at
    the widest shape the kernel is checked at, errs by less than an eighth of the bound."""
    gen = torch.Generator().manual_seed(1)
    b, n, h, dh = 2, 196, 16, 64
    qkv, g = torch.randn(b, n, 3 * h * dh, generator=gen), torch.randn(b, n, h * dh, generator=gen)
    mask = torch.rand(b, n, generator=gen) > 0.3
    mask[:, 0] = True
    bias = fa._key_bias(mask)
    out32 = fa._bwd_plain(qkv, g, h, bias, dh**-0.5)
    # the same sums in float64: _bwd_plain's steps, written out
    x = qkv.double().reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]
    go = g.double().reshape(b, n, h, dh).permute(0, 2, 1, 3)
    s = q @ k.transpose(-1, -2) * dh**-0.5 + bias.double()[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    a = e / e.sum(-1, keepdim=True)
    da = go @ v.transpose(-1, -2)
    ds = a * (da - (da * a).sum(-1, keepdim=True)) * dh**-0.5
    parts = [ds @ k, ds.transpose(-1, -2) @ q, a.transpose(-1, -2) @ go]
    out64 = torch.cat([p.permute(0, 2, 1, 3).reshape(b, n, h * dh) for p in parts], dim=-1)
    assert (out32.double() - out64).abs().max().item() < BWD_F32_TOL / 8


def test_bwd_launch_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa._launch_bwd(torch.zeros(2, 10, 3 * 64), torch.zeros(2, 10, 64), 1, None, 0.125)
    assert not (tmp_path / "build").exists()
