"""The port's split-head attention (v1) against JAX ``flash_attention`` on the CPU, against the
port's own packed (v2) plain path, and the attention-layer bench's variants.

The JAX side runs the Pallas ``_fwd_kernel`` / ``_bwd_kernel`` in interpret mode, as
``tests/test_flash_attention.py`` does; gradients through ``jax.vjp`` of its custom VJP.
Inputs come from numpy with a seed. Tolerances: f32 at atol 2e-6, as
``tests/test_flash_attention.py`` holds the Pallas kernel to its einsum reference; bf16 within
``flash_attention_tolerance`` / ``flash_attention_bwd_tolerance``, the bounds the CUDA kernels
are held to on the card. The v1 plain path is the packed one with batch B*H and one head, so
it must equal the packed plain path exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3l_tpu.nn.flash_attention import flash_attention as jax_flash_attention
from m3l_tpu_torch import bench_attention as bench
from m3l_tpu_torch.kernels import build
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.nn.flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_bwd_tolerance,
    flash_attention_qkv_bwd_reference,
    flash_attention_qkv_reference,
    flash_attention_reference,
    flash_attention_tolerance,
)


def _inputs(b, n, h, dh, masked, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, n, h, dh)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = rng.uniform(size=(b, n)) > 0.4
        mask[:, 0] = True  # every row keeps one key
    return (q, k, v), g, mask


def _jax(qkv, g, mask, dtype=jnp.float32):
    """JAX v1 forward and (dq, dk, dv) for the cotangent g, as f32 numpy."""
    jm = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, key_mask=jm, interpret=True),
                       *(jnp.asarray(a, dtype) for a in qkv))
    grads = vjp(jnp.asarray(g, dtype))
    return np.asarray(out.astype(jnp.float32)), [np.asarray(x.astype(jnp.float32)) for x in grads]


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [192, 17, 64])
def test_v1_forward_and_gradients_match_jax(n, masked):
    qkv, g, mask = _inputs(2, n, 4, 64, masked, seed=n)
    ref, ref_grads = _jax(qkv, g, mask)
    leaves = [_t(a).requires_grad_(True) for a in qkv]
    out = flash_attention(*leaves, key_mask=_t(mask, torch.bool))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=2e-6)
    out.backward(_t(g))
    for name, leaf, expected in zip("qkv", leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), expected, rtol=0, atol=2e-6, err_msg=f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_v1_plain_path_equals_the_packed_plain_path(dtype, masked):
    (q, k, v), g, mask = _inputs(3, 24, 2, 32, masked, seed=1)
    tq, tk, tv, tg = (_t(a, dtype) for a in (q, k, v, g))
    tm = _t(mask, torch.bool)
    b, n, h, dh = q.shape
    packed = torch.cat([x.reshape(b, n, h * dh) for x in (tq, tk, tv)], dim=-1)
    out = flash_attention_reference(tq, tk, tv, key_mask=tm)
    assert out.dtype == dtype and out.shape == (b, n, h, dh)
    assert torch.equal(out.reshape(b, n, h * dh), flash_attention_qkv_reference(packed, h, key_mask=tm))
    grads = flash_attention_bwd_reference(tq, tk, tv, tg, key_mask=tm)
    expected = flash_attention_qkv_bwd_reference(packed, tg.reshape(b, n, h * dh), h, key_mask=tm).chunk(3, dim=-1)
    for got, want in zip(grads, expected):
        assert got.dtype == dtype and torch.equal(got.reshape(b, n, h * dh), want)


@pytest.mark.parametrize("masked", [False, True])
def test_v1_autograd_on_cpu_gives_the_plain_backward(masked):
    qkv, g, mask = _inputs(2, 20, 3, 16, masked, seed=2)
    tm = _t(mask, torch.bool)
    leaves = [_t(a).requires_grad_(True) for a in qkv]
    out = flash_attention(*leaves, key_mask=tm, scale=0.3)
    assert torch.equal(out, flash_attention_reference(*(_t(a) for a in qkv), key_mask=tm, scale=0.3))
    out.backward(_t(g))
    expected = flash_attention_bwd_reference(*(_t(a) for a in qkv), _t(g), key_mask=tm, scale=0.3)
    for leaf, want in zip(leaves, expected):
        assert torch.equal(leaf.grad, want)


@pytest.mark.parametrize("masked", [False, True])
def test_v1_bf16_within_kernel_tolerance_of_jax(masked):
    """The bounds the CUDA v1 kernels are held to also cover the Pallas kernels' bf16 results,
    and are tight enough to see a dropped key."""
    qkv, g, mask = _inputs(3, 24, 2, 32, masked, seed=4)
    rounded = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in (*qkv, g)]
    ref, ref_grads = _jax(rounded[:3], rounded[3], mask, jnp.bfloat16)
    tq, tk, tv, tg = (_t(a, torch.bfloat16) for a in rounded)
    tm = _t(mask, torch.bool)
    out = flash_attention_reference(tq, tk, tv, key_mask=tm)
    tol = flash_attention_tolerance(tq, tk, tv, out, key_mask=tm)
    assert (np.abs(out.float().numpy() - ref) <= tol.numpy()).all()
    grads = flash_attention_bwd_reference(tq, tk, tv, tg, key_mask=tm)
    tols = flash_attention_bwd_tolerance(tq, tk, tv, tg, grads, key_mask=tm)
    for got, want, t in zip(grads, ref_grads, tols):
        assert (np.abs(got.float().numpy() - want) <= t.numpy()).all()
    dropped = flash_attention_reference(tq[:, 1:], tk[:, 1:], tv[:, 1:], key_mask=None if tm is None else tm[:, 1:])
    assert (np.abs(dropped.float().numpy() - ref[:, 1:]) > tol.numpy()[:, 1:]).any()


def test_v1_refuses_what_it_does_not_take(monkeypatch, tmp_path):
    q = torch.zeros(2, 10, 2, 64)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(*(torch.empty(2, 10, 2, 64, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="share one"):
        flash_attention(q, q, torch.zeros(2, 11, 2, 64))
    with pytest.raises(ValueError, match="key_mask"):
        flash_attention(q, q, q, key_mask=torch.ones(2, 11, dtype=torch.bool))
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_v1(torch.zeros(4, 10, 12))
    with pytest.raises(ValueError, match="contiguous"):
        fa._check_v1(torch.zeros(4, 64, 10).transpose(1, 2))
    # the kernel path raises without nvcc, rather than returning the plain result
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty_bin"))
    c = torch.zeros(4, 10, 64)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa._launch_v1(c, c, c, None, 0.125)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa._launch_v1_bwd(c, c, c, c, None, 0.125)
    assert not (tmp_path / "build").exists()


def test_bench_layers_agree_on_the_cpu():
    """The bench's v1 and v2 layers give the same loss and gradients, bit for bit (the same
    arithmetic on the same numbers); the einsum yardstick agrees to bf16 rounding."""
    params, x = bench.make_inputs(2, 24, 64, device="cpu")
    loss2, grads2 = bench.loss_and_grads("v2", params, x, heads=2)
    loss1, grads1 = bench.loss_and_grads("v1", params, x, heads=2)
    assert torch.equal(loss1, loss2) and all(torch.equal(a, b) for a, b in zip(grads1, grads2))
    loss_e, _ = bench.loss_and_grads("einsum", params, x, heads=2)
    np.testing.assert_allclose(loss_e.item(), loss2.item(), rtol=2e-2)
    before = [p.clone() for p in params]
    bench.train_steps("v1", params, x, heads=2, inner=2)
    assert all(not torch.equal(a, b) for a, b in zip(params, before))
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.time_variant("v1", params, x, heads=2)
