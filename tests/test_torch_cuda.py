"""The CUDA kernel against its plain version on the card. Marked ``cuda``: each test skips
where no card is present, and runs on the H100 with ``python -m pytest tests/test_torch_cuda.py``.

Tolerance: the elementwise bound of ``flash_attention_qkv_tolerance``, whose docstring gives
the reasons: f32 abs 1e-5; bf16 one ulp of the output plus one ulp of each probability times
|v|, the two roundings at which an f32 result ~1e-6 apart can land on adjacent bf16 values.
"""
import pytest
import torch

from m3l_tpu_torch.kernels import LAUNCHES
from m3l_tpu_torch.nn.flash_attention import (
    KERNEL,
    flash_attention_qkv,
    flash_attention_qkv_reference,
    flash_attention_qkv_tolerance,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", [(8, 10, 4, 64), (8, 192, 4, 64), (2, 196, 16, 64), (3, 1, 2, 8), (2, 33, 2, 128)])
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain(card, b, n, h, dh, dtype, masked):
    g = torch.Generator(device=card).manual_seed(0)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g, device=card).to(dtype)
    mask = None
    if masked:
        mask = torch.rand(b, n, generator=g, device=card) > 0.3
        mask[:, 0] = True
    before = LAUNCHES[KERNEL]
    out = flash_attention_qkv(qkv, h, key_mask=mask)
    torch.cuda.synchronize()
    assert LAUNCHES[KERNEL] == before + 1
    ref = flash_attention_qkv_reference(qkv, h, key_mask=mask)
    assert out.dtype == dtype and out.shape == (b, n, h * dh)
    tol = flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)
    assert ((out.float() - ref.float()).abs() <= tol).all()


def test_kernel_refuses_inputs_it_does_not_take(card):
    with pytest.raises(TypeError):
        flash_attention_qkv(torch.zeros(2, 10, 192, device=card, dtype=torch.float16), 1)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_qkv(torch.zeros(2, 10, 3 * 12, device=card), 1)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_qkv(torch.zeros(2, 3 * 64, 10, device=card).transpose(1, 2), 1)
    with pytest.raises(NotImplementedError):
        flash_attention_qkv(torch.zeros(2, 10, 192, device=card, requires_grad=True), 1)
