"""A long head through the port's plain attention against the JAX Pallas kernels in interpret
mode on the CPU: N = 784 (8 frames at tubelet 2 on a 14 x 14 patch grid), B = 1, H = 2, Dh = 64,
f32, with and without a key mask. The CUDA bodies stream such a head through shared memory in
tiles (tests/test_torch_cuda.py holds them to these plain versions on the card); this holds
the plain versions themselves, forward and gradient, to the reference at that length.

Both sides get the same packed qkv, cotangent and key mask, made with numpy from a seed, and
compare at rtol/atol 1e-5: the same f32 products, exp and division in another summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3l_tpu.nn.flash_attention import flash_attention_qkv as jax_flash_attention_qkv
from m3l_tpu_torch.nn.flash_attention import flash_attention_qkv

B, N, H, DH = 1, 784, 2, 64
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_long_head_forward_and_gradient_match_pallas_interpret(masked):
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(B, N, 3 * H * DH)).astype(np.float32)
    cot = rng.normal(size=(B, N, H * DH)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(B, N)) > 0.3
        mask[:, 0] = True
    jmask = None if mask is None else jnp.asarray(mask)

    def jax_fn(x):
        return jax_flash_attention_qkv(x, H, key_mask=jmask, interpret=True)

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(qkv))
    (ref_grad,) = vjp(jnp.asarray(cot))

    x = torch.from_numpy(qkv).requires_grad_(True)
    out = flash_attention_qkv(x, H, key_mask=None if mask is None else torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(out, x, torch.from_numpy(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), **TOL)
