"""The port's plain attention (m3l_tpu_torch flash_attention_qkv_reference and the CPU path of
flash_attention_qkv) against the JAX Pallas kernel run in interpret mode on the CPU.

Both sides get the same packed qkv and key mask, made with numpy from a seed, and compare in
f32 at rtol/atol 1e-5: the two compute the same f32 products, exp and division, and differ
only in summation order (~1e-7 relative at these widths). The CUDA kernel itself is held
against the same plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3l_tpu.nn.flash_attention import flash_attention_qkv as jax_flash_attention_qkv
from m3l_tpu_torch.nn.flash_attention import (
    flash_attention_qkv,
    flash_attention_qkv_reference,
    flash_attention_qkv_tolerance,
)


def _inputs(b, n, h, dh, masked, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3 * h * dh)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(b, n)) > 0.3
        mask[:, 0] = True  # every row keeps one key
    return qkv, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("h", [1, 2, 4])
@pytest.mark.parametrize("n", [10, 24])
def test_reference_matches_pallas_interpret(n, h, masked):
    qkv, mask = _inputs(2, n, h, 16, masked)
    ref = jax_flash_attention_qkv(
        jnp.asarray(qkv), h, key_mask=None if mask is None else jnp.asarray(mask), interpret=True
    )
    out = flash_attention_qkv_reference(
        torch.from_numpy(qkv), h, key_mask=None if mask is None else torch.from_numpy(mask)
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_fully_masked_row_is_uniform_like_jax():
    """A batch row with every key masked: all scores are -1e30, the softmax is uniform."""
    qkv, _ = _inputs(2, 10, 2, 16, False, seed=3)
    mask = np.ones((2, 10), bool)
    mask[1] = False
    ref = jax_flash_attention_qkv(jnp.asarray(qkv), 2, key_mask=jnp.asarray(mask), interpret=True)
    out = flash_attention_qkv_reference(torch.from_numpy(qkv), 2, key_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version_with_explicit_scale():
    qkv, mask = _inputs(3, 24, 4, 8, True, seed=1)
    q, m = torch.from_numpy(qkv), torch.from_numpy(mask)
    np.testing.assert_array_equal(
        flash_attention_qkv(q, 4, key_mask=m, scale=0.3).numpy(),
        flash_attention_qkv_reference(q, 4, key_mask=m, scale=0.3).numpy(),
    )
    ref = jax_flash_attention_qkv(jnp.asarray(qkv), 4, key_mask=jnp.asarray(mask), scale=0.3, interpret=True)
    np.testing.assert_allclose(flash_attention_qkv(q, 4, key_mask=m, scale=0.3).numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_bf16_rounds_probabilities_like_jax():
    """bf16 inputs: both round A to bf16 before A.V and the output to bf16."""
    qkv, _ = _inputs(2, 24, 2, 16, False, seed=2)
    jq = jnp.asarray(qkv, dtype=jnp.bfloat16)
    ref = np.asarray(jax_flash_attention_qkv(jq, 2, interpret=True).astype(jnp.float32))
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(torch.bfloat16)
    out = flash_attention_qkv_reference(tq, 2).float().numpy()
    # summation order may move an f32 result across a bf16 rounding boundary: one bf16 ulp
    np.testing.assert_allclose(out, ref, rtol=2**-7, atol=2**-9)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [10, 24])
def test_bf16_within_kernel_tolerance_of_jax(n, masked):
    """The elementwise bound the CUDA kernel is held to also covers a second implementation of
    the same bf16 arithmetic: the Pallas kernel's, with its own summation order and exp."""
    qkv, mask = _inputs(3, n, 2, 32, masked, seed=4)
    jq = jnp.asarray(qkv, dtype=jnp.bfloat16)
    jm = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(jax_flash_attention_qkv(jq, 2, key_mask=jm, interpret=True).astype(jnp.float32))
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(torch.bfloat16)
    tm = None if mask is None else torch.from_numpy(mask)
    out = flash_attention_qkv_reference(tq, 2, key_mask=tm)
    tol = flash_attention_qkv_tolerance(tq, 2, out, key_mask=tm).numpy()
    assert (np.abs(out.float().numpy() - ref) <= tol).all()
    # the bound is tight enough to see a dropped key
    wrong = flash_attention_qkv_reference(tq[:, 1:], 2, key_mask=None if tm is None else tm[:, 1:])
    assert (np.abs(wrong.float().numpy() - ref[:, 1:]) > tol[:, 1:]).any()
