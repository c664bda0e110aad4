"""The CUDA kernels against their plain versions on the card. Marked ``cuda``: each test skips
where no card is present, and runs on the H100 with ``python -m pytest tests/test_torch_cuda.py``.

Tolerances: the elementwise bounds of ``flash_attention_qkv_tolerance`` and
``flash_attention_qkv_bwd_tolerance``, whose docstrings give the reasons. Forward: f32 abs
1e-5; bf16 one ulp of the output plus one ulp of each probability times |v|. Backward: f32 abs
2e-5; bf16 one ulp of dqkv plus the worst-case f32 summation-order term (N + Dh + 8) * eps32
times the sums over |terms|. The split-head (v1) kernels are held to the same bounds
(``flash_attention_tolerance``, ``flash_attention_bwd_tolerance``), and to the packed kernels'
results on the same numbers, bit for bit: both pairs run the same kernel bodies. Every body
runs on the tensor cores: the bf16 forward (one pass, the unnormalised probabilities rounded to
bf16) and backward (A and dS split into two bf16 terms) as ``"tensor_core"``, the f32 forward
and backward in 3xTF32 (every operand split into two TF32 terms) as ``"tf32x3"``. ``FWD_BODY_LAUNCHES`` and
``BWD_BODY_LAUNCHES`` show which body served a launch. Every body takes heads of any length: a
head too long for shared memory streams through it in tiles (``LENGTH_EDGES``: the longest head
each body staged whole, and one more).
"""
import copy
from collections import Counter

import pytest
import torch

from m3l_tpu_torch.kernels import BWD_BODY_LAUNCHES, FWD_BODY_LAUNCHES, LAUNCHES
from m3l_tpu_torch.nn import flash_attention as fa
from m3l_tpu_torch.nn.flash_attention import (
    BWD_KERNEL,
    KERNEL,
    V1_BWD_KERNEL,
    V1_KERNEL,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_bwd_tolerance,
    flash_attention_qkv,
    flash_attention_qkv_bwd_reference,
    flash_attention_qkv_bwd_tolerance,
    flash_attention_qkv_reference,
    flash_attention_qkv_tolerance,
    flash_attention_reference,
    flash_attention_tolerance,
)

pytestmark = pytest.mark.cuda

SHAPES = [(8, 10, 4, 64), (8, 192, 4, 64), (2, 196, 16, 64), (3, 1, 2, 8), (2, 33, 2, 128)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(card, b, n, h, dh, dtype, masked):
    g = torch.Generator(device=card).manual_seed(0)
    qkv = torch.randn(b, n, 3 * h * dh, generator=g, device=card).to(dtype)
    cot = torch.randn(b, n, h * dh, generator=g, device=card).to(dtype)
    mask = None
    if masked:
        mask = torch.rand(b, n, generator=g, device=card) > 0.3
        mask[:, 0] = True
    return qkv, cot, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_plain(card, b, n, h, dh, dtype, masked):
    qkv, _, mask = _inputs(card, b, n, h, dh, dtype, masked)
    before = LAUNCHES[KERNEL]
    out = flash_attention_qkv(qkv, h, key_mask=mask)
    torch.cuda.synchronize()
    assert LAUNCHES[KERNEL] == before + 1
    ref = flash_attention_qkv_reference(qkv, h, key_mask=mask)
    assert out.dtype == dtype and out.shape == (b, n, h * dh)
    tol = flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)
    assert ((out.float() - ref.float()).abs() <= tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", SHAPES + [(512, 192, 4, 64), (512, 10, 4, 64), (64, 196, 16, 64)])
@pytest.mark.parametrize("masked", [False, True])
def test_bwd_kernel_matches_plain(card, b, n, h, dh, dtype, masked):
    qkv, cot, mask = _inputs(card, b, n, h, dh, dtype, masked)
    bias = None if mask is None else fa._key_bias(mask)
    before = LAUNCHES[BWD_KERNEL]
    out = fa._launch_bwd(qkv, cot, h, bias, dh**-0.5)
    torch.cuda.synchronize()
    assert LAUNCHES[BWD_KERNEL] == before + 1
    ref = flash_attention_qkv_bwd_reference(qkv, cot, h, key_mask=mask)
    assert out.dtype == dtype and out.shape == qkv.shape and torch.isfinite(out).all()
    tol = flash_attention_qkv_bwd_tolerance(qkv, cot, h, ref, key_mask=mask)
    assert ((out.float() - ref.float()).abs() <= tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradient_through_autograd_function(card, dtype):
    """backward() through flash_attention_qkv launches each kernel once and gives the plain
    backward of the cotangent; a fully masked batch row and an expanded cotangent included."""
    b, n, h, dh = 3, 40, 2, 64
    qkv, cot, mask = _inputs(card, b, n, h, dh, dtype, True)
    mask[1] = False
    x = qkv.clone().requires_grad_(True)
    f0, b0 = LAUNCHES[KERNEL], LAUNCHES[BWD_KERNEL]
    out = flash_attention_qkv(x, h, key_mask=mask)
    (out.float() * cot.float()).sum().backward()
    torch.cuda.synchronize()
    assert (LAUNCHES[KERNEL], LAUNCHES[BWD_KERNEL]) == (f0 + 1, b0 + 1)
    ref = flash_attention_qkv_bwd_reference(qkv, cot, h, key_mask=mask)
    tol = flash_attention_qkv_bwd_tolerance(qkv, cot, h, ref, key_mask=mask)
    assert x.grad.dtype == dtype and ((x.grad.float() - ref.float()).abs() <= tol).all()
    # sum() hands backward an expanded cotangent of ones
    x.grad = None
    flash_attention_qkv(x, h).sum().backward()
    ones = torch.ones(b, n, h * dh, device=card, dtype=dtype)
    ref = flash_attention_qkv_bwd_reference(qkv, ones, h)
    tol = flash_attention_qkv_bwd_tolerance(qkv, ones, h, ref)
    assert ((x.grad.float() - ref.float()).abs() <= tol).all()


def _fwd_case(card, b, n, h, dh, dtype, mask):
    """One forward launch of each interface against the plain version; the two equal bit for bit.
    Returns the body that served them."""
    qkv, _, _ = _inputs(card, b, n, h, dh, dtype, False)
    bodies = Counter(FWD_BODY_LAUNCHES)
    out = flash_attention_qkv(qkv, h, key_mask=mask)
    q, k, v = _split(qkv, h)
    out_v1 = flash_attention(q, k, v, key_mask=mask)
    torch.cuda.synchronize()
    body, other = (FWD_BODY_LAUNCHES - bodies).elements()
    ref = flash_attention_qkv_reference(qkv, h, key_mask=mask)
    tol = flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)
    assert out.dtype == dtype and torch.isfinite(out).all() and ((out.float() - ref.float()).abs() <= tol).all()
    assert body == other and torch.equal(out_v1.reshape(b, n, h * dh), out)
    return body


@pytest.mark.parametrize("dh", [8, 64, 128])
@pytest.mark.parametrize("n", [1, 10, 33, 196])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_fwd_on_the_tensor_cores(card, n, dh, masked):
    """Ragged N (padded to 16 with -inf keys) and head dims that are not a multiple of 16."""
    mask = None
    if masked:
        mask = torch.rand(3, n, generator=torch.Generator(device=card).manual_seed(1), device=card) > 0.3
        mask[:, 0] = True
    assert _fwd_case(card, 3, n, 2, dh, torch.bfloat16, mask) == "tensor_core"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_with_a_fully_masked_row(card, dtype):
    mask = torch.ones(3, 40, dtype=torch.bool, device=card)
    mask[1] = False
    mask[2, 20:] = False
    body = _fwd_case(card, 3, 40, 2, 64, dtype, mask)
    assert body == ("tensor_core" if dtype == torch.bfloat16 else "tf32x3")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_body_at_the_model_shapes(card, dtype):
    """Every bf16 forward at the model shapes (N = 192 and the 10 kept tokens, H = 4, Dh = 64;
    the SSL encoder's N = 196, H = 16) takes the bf16 body, every f32 one the 3xTF32 body, in
    both interfaces."""
    want = "tensor_core" if dtype == torch.bfloat16 else "tf32x3"
    for b, n, h in ((8, 192, 4), (8, 10, 4), (2, 196, 16)):
        assert _fwd_case(card, b, n, h, 64, dtype, None) == want


@pytest.mark.parametrize("n,dh", [(700, 64), (384, 128)])
def test_bf16_fwd_past_the_cuda_core_body_shared_memory(card, n, dh):
    """The tensor-core forward stages only K and V, so it takes bf16 heads the CUDA-core body's
    shared memory refused (N > 578 at Dh = 64, N > 335 at Dh = 128)."""
    assert _fwd_case(card, 2, n, 1, dh, torch.bfloat16, None) == "tensor_core"


def _bwd_case(card, b, n, h, dh, dtype, mask):
    """One backward launch of each interface against the plain version; the two equal bit for
    bit. Returns the body that served them."""
    qkv, cot, _ = _inputs(card, b, n, h, dh, dtype, False)
    bodies = Counter(BWD_BODY_LAUNCHES)
    out = fa._launch_bwd(qkv, cot, h, None if mask is None else fa._key_bias(mask), dh**-0.5)
    q, k, v = _split(qkv, h)
    bias_v1 = None if mask is None else fa._key_bias(fa._v1_mask(mask, h))
    grads = fa._launch_v1_bwd(*(fa._collapse(t) for t in (q, k, v, cot.view(b, n, h, dh))), bias_v1, dh**-0.5)
    torch.cuda.synchronize()
    body, other = (BWD_BODY_LAUNCHES - bodies).elements()
    ref = flash_attention_qkv_bwd_reference(qkv, cot, h, key_mask=mask)
    tol = flash_attention_qkv_bwd_tolerance(qkv, cot, h, ref, key_mask=mask)
    assert out.dtype == dtype and torch.isfinite(out).all() and ((out.float() - ref.float()).abs() <= tol).all()
    assert body == other and torch.equal(torch.cat([fa._uncollapse(t, h).reshape(b, n, h * dh) for t in grads], dim=-1), out)
    return body


@pytest.mark.parametrize("dh", [8, 64, 128])
@pytest.mark.parametrize("n", [1, 10, 33, 196])
@pytest.mark.parametrize("masked", [False, True])
def test_bf16_bwd_on_the_tensor_cores(card, n, dh, masked):
    """Ragged N (padded to 16 with -inf keys) and head dims that are not a multiple of 16."""
    mask = None
    if masked:
        mask = torch.rand(3, n, generator=torch.Generator(device=card).manual_seed(1), device=card) > 0.3
        mask[:, 0] = True
    assert _bwd_case(card, 3, n, 2, dh, torch.bfloat16, mask) == "tensor_core"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_with_a_fully_masked_row(card, dtype):
    mask = torch.ones(3, 40, dtype=torch.bool, device=card)
    mask[1] = False
    mask[2, 20:] = False
    body = _bwd_case(card, 3, 40, 2, 64, dtype, mask)
    assert body == ("tensor_core" if dtype == torch.bfloat16 else "tf32x3")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_body_at_the_model_shapes(card, dtype):
    """Every bf16 backward at the model shapes (N = 192 and the 10 kept tokens, H = 4, Dh = 64)
    takes the bf16 body, every f32 one the 3xTF32 body, in both interfaces."""
    want = "tensor_core" if dtype == torch.bfloat16 else "tf32x3"
    for n in (192, 10):
        assert _bwd_case(card, 8, n, 4, 64, dtype, None) == want
        x = torch.zeros(32, n, 64, device=card, dtype=dtype)
        bodies = Counter(BWD_BODY_LAUNCHES)
        fa._launch_v1_bwd(x, x, x, x, None, 0.125)
        assert BWD_BODY_LAUNCHES - bodies == Counter({want: 1})


@pytest.mark.parametrize("n,dh", [(240, 128), (400, 64)])
def test_bf16_bwd_past_the_whole_head_shared_memory_stays_on_the_tensor_cores(card, n, dh):
    """A bf16 head whose staged Q, K, V, g exceed the 227 KB a block can use (N > 208 at Dh = 128,
    N > 384 at Dh = 64) streams through the tensor-core body in tiles, within bound."""
    assert _bwd_case(card, 2, n, 1, dh, torch.bfloat16, None) == "tensor_core"


# The longest head each body stages whole (in one tile) and one more, per direction, dtype and
# head dim; the bf16 backward also at the old CUDA-core passes' limit (406 / 253), which took
# bf16 heads past its own.
LENGTH_EDGES = [
    ("fwd", torch.bfloat16, 64, (784, 785)),
    ("fwd", torch.bfloat16, 128, (416, 417)),
    ("bwd", torch.bfloat16, 64, (384, 385, 406, 407)),
    ("bwd", torch.bfloat16, 128, (208, 209, 253, 254)),
    ("fwd", torch.float32, 64, (416, 417)),
    ("fwd", torch.float32, 128, (208, 209)),
    ("bwd", torch.float32, 64, (400, 401)),
    ("bwd", torch.float32, 128, (208, 209)),
]


def _key_mask(card, n, masked):
    if not masked:
        return None
    mask = torch.rand(2, n, generator=torch.Generator(device=card).manual_seed(2), device=card) > 0.3
    mask[:, 0] = True
    return mask


@pytest.mark.parametrize("direction,dtype,dh,n", [(d, t, dh, n) for d, t, dh, ns in LENGTH_EDGES for n in ns])
@pytest.mark.parametrize("masked", [False, True])
def test_heads_of_any_length(card, direction, dtype, dh, n, masked):
    """No body has a length limit: each side of each old whole-head limit is within bound, both
    interfaces agree bit for bit, and each dtype stays on its body."""
    case = _fwd_case if direction == "fwd" else _bwd_case
    body = case(card, 2, n, 2, dh, dtype, _key_mask(card, n, masked))
    assert body == ("tensor_core" if dtype == torch.bfloat16 else "tf32x3")


@pytest.mark.parametrize("dtype,n", [(torch.bfloat16, 784), (torch.float32, 400)])
@pytest.mark.parametrize("masked", [False, True])
def test_long_heads_forward_and_backward(card, dtype, n, masked):
    """N = 784 (8 frames at tubelet 2 on a 14 x 14 grid) in bf16 and N = 400 in f32, four heads of
    64, through autograd: the forward and the backward within the plain versions' bounds."""
    b, h, dh = 2, 4, 64
    qkv, cot, _ = _inputs(card, b, n, h, dh, dtype, False)
    mask = _key_mask(card, n, masked)
    x = qkv.clone().requires_grad_(True)
    out = flash_attention_qkv(x, h, key_mask=mask)
    (grad,) = torch.autograd.grad(out, x, cot)
    torch.cuda.synchronize()
    ref = flash_attention_qkv_reference(qkv, h, key_mask=mask)
    assert ((out.float() - ref.float()).abs() <= flash_attention_qkv_tolerance(qkv, h, ref, key_mask=mask)).all()
    ref = flash_attention_qkv_bwd_reference(qkv, cot, h, key_mask=mask)
    tol = flash_attention_qkv_bwd_tolerance(qkv, cot, h, ref, key_mask=mask)
    assert torch.isfinite(grad).all() and ((grad.float() - ref.float()).abs() <= tol).all()


def test_kernel_refuses_inputs_it_does_not_take(card):
    with pytest.raises(TypeError):
        flash_attention_qkv(torch.zeros(2, 10, 192, device=card, dtype=torch.float16), 1)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_qkv(torch.zeros(2, 10, 3 * 12, device=card), 1)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_qkv(torch.zeros(2, 3 * 64, 10, device=card).transpose(1, 2), 1)
    qkv = torch.zeros(2, 10, 192, device=card)
    with pytest.raises(ValueError, match="cotangent"):
        fa._launch_bwd(qkv, torch.zeros(2, 10, 64, device=card, dtype=torch.bfloat16), 1, None, 0.125)
    with pytest.raises(ValueError, match="cotangent"):
        fa._launch_bwd(qkv, torch.zeros(2, 10, 32, device=card), 1, None, 0.125)


def _split(qkv, h):
    """Packed (B, N, 3*H*Dh) -> contiguous q, k, v (B, N, H, Dh)."""
    b, n, thd = qkv.shape
    return [t.contiguous() for t in qkv.view(b, n, 3, h, thd // (3 * h)).unbind(2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", SHAPES + [(512, 192, 4, 64), (512, 10, 4, 64), (64, 196, 16, 64)])
@pytest.mark.parametrize("masked", [False, True])
def test_v1_kernels_match_plain_and_the_packed_kernels(card, b, n, h, dh, dtype, masked):
    """Forward and backward (through autograd) of the split-head kernels: within the plain
    versions' bounds, and equal to the packed kernels on the same numbers."""
    qkv, cot, mask = _inputs(card, b, n, h, dh, dtype, masked)
    q, k, v = (t.requires_grad_(True) for t in _split(qkv, h))
    g = cot.view(b, n, h, dh)
    before = (LAUNCHES[V1_KERNEL], LAUNCHES[V1_BWD_KERNEL])
    out = flash_attention(q, k, v, key_mask=mask)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert (LAUNCHES[V1_KERNEL], LAUNCHES[V1_BWD_KERNEL]) == (before[0] + 1, before[1] + 1)
    q, k, v = (t.detach() for t in (q, k, v))
    ref = flash_attention_reference(q, k, v, key_mask=mask)
    assert out.dtype == dtype and out.shape == (b, n, h, dh)
    assert ((out.float() - ref.float()).abs() <= flash_attention_tolerance(q, k, v, ref, key_mask=mask)).all()
    refs = flash_attention_bwd_reference(q, k, v, g, key_mask=mask)
    for got, want, tol in zip(grads, refs, flash_attention_bwd_tolerance(q, k, v, g, refs, key_mask=mask)):
        assert got.dtype == dtype and torch.isfinite(got).all() and ((got.float() - want.float()).abs() <= tol).all()
    bias = None if mask is None else fa._key_bias(mask)
    assert torch.equal(out.reshape(b, n, h * dh), flash_attention_qkv(qkv, h, key_mask=mask))
    dqkv = fa._launch_bwd(qkv, cot, h, bias, dh**-0.5)
    assert torch.equal(torch.cat([x.reshape(b, n, h * dh) for x in grads], dim=-1), dqkv)


def test_v1_kernel_refuses_inputs_it_does_not_take(card):
    x = torch.zeros(4, 10, 64, device=card)
    with pytest.raises(TypeError):
        fa._launch_v1(*(x.half() for _ in range(3)), None, 0.125)
    with pytest.raises(ValueError, match="every operand"):
        fa._launch_v1(x, x, x.bfloat16(), None, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        fa._launch_v1(x, x, torch.zeros(4, 64, 10, device=card).transpose(1, 2), None, 0.125)
    with pytest.raises(ValueError, match="every operand"):
        fa._launch_v1_bwd(x, x, x, torch.zeros(4, 10, 32, device=card), None, 0.125)


# The SSL slices' shapes at batch 64: MAE's masked encoder (49 of 196 patches kept), the full-image
# encoder, and the He-style decoder (512 wide, 16 heads of 32); DINO's views (196 patches + 1
# register) and the I-JEPA predictor (196 context + 196 mask tokens, 12 heads of 32).
SSL_SHAPES = [(64, 49, 6, 64), (64, 196, 6, 64), (64, 196, 16, 32), (64, 197, 6, 64), (64, 392, 12, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,dh", SSL_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_packed_pair_at_the_ssl_shapes(card, b, n, h, dh, dtype, masked):
    """Forward and backward of both interfaces within bound at the SSL shapes, bf16 on the
    bf16 body (Dh 32: two 16-wide k-steps), f32 on the 3xTF32 body (16 heads)."""
    mask = None
    if masked:
        mask = torch.rand(b, n, generator=torch.Generator(device=card).manual_seed(2), device=card) > 0.3
        mask[:, 0] = True
    want = "tensor_core" if dtype == torch.bfloat16 else "tf32x3"
    assert _fwd_case(card, b, n, h, dh, dtype, mask) == want
    assert _bwd_case(card, b, n, h, dh, dtype, mask) == want


def test_f32_mae_step_matches_the_cpu(card):
    """One f32 step of a small ViT + He-style MAE (both attention layers of the encoder and the
    decoder's on the kernels) on the card against the same weights, batch and masking noise on
    the CPU: the loss, each gradient relative to its norm, and the parameters after AdamW beyond
    the difference of Adam's first steps lr * g / (|g| + eps) the two gradients imply (a gradient
    that is zero analytically, as the key third of each qkv bias, is f32 noise that Adam turns
    into a step of up to lr). The same checks as chip_smoke.py phase 9 (a), at 1e-5, 1e-5 and
    1e-2 * lr."""
    from m3l_tpu_torch.models.vit import VisionTransformer
    from m3l_tpu_torch.ssl import MAEModule

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the patch conv in f32, as on the CPU
    try:
        _mae_step_errors(card, VisionTransformer, MAEModule)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def _mae_step_errors(card, VisionTransformer, MAEModule):
    torch.manual_seed(0)
    vit = VisionTransformer(img_size=(64, 64), patch_size=8, in_chans=6, embed_dim=128, depth=2, num_heads=2, pos_embed_fn="sinusoidal")
    cpu = MAEModule(vit, decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=2, warmup_epochs=0)
    gpu = copy.deepcopy(cpu).to(card)
    x = torch.rand(4, 64, 64, 6, generator=torch.Generator().manual_seed(1))
    noise = torch.rand(4, cpu.num_patches, generator=torch.Generator().manual_seed(2))
    results = []
    for m, dev in ((gpu, card), (cpu, torch.device("cpu"))):
        m.sample_noise = lambda b, g, dev=dev: noise.to(dev)
        opt = m.configure_optimizer(2, 2)
        start = Counter(LAUNCHES)
        loss, _ = m.training_loss({"image": x.to(dev)}, None, 0)
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in m.named_parameters()}
        opt.step()
        launched = {k: LAUNCHES[k] - start[k] for k in (KERNEL, BWD_KERNEL)}
        results.append((loss.item(), grads, {n: p.detach().cpu() for n, p in m.named_parameters()}, launched, opt))
    (la, ga, pa, launched, opt), (lb, gb, pb, _, _) = results
    assert launched == {KERNEL: 3, BWD_KERNEL: 3}
    assert abs(la - lb) <= 1e-5 * abs(lb)
    lr, eps = opt.learning_rate(0), 1e-8
    for name, g in gb.items():
        a = ga[name]
        assert (a - g).norm() <= 1e-5 * g.norm(), name
        implied = lr * (a / (a.abs() + eps) - g / (g.abs() + eps)).abs()
        assert ((pa[name] - pb[name]).abs() - implied).max() <= 1e-2 * lr, name


def test_f32_dino_step_matches_the_cpu(card):
    """One f32 step of a small ViT (one register token) + DINO with the probe on the card against
    the same weights, batch, masks and temperature on the CPU, every attention layer on the
    kernels with a key mask but the probe's: the loss, each trainable gradient relative to its
    norm, the parameters after AdamW beyond the difference of Adam's first steps that the two
    gradients imply, the teachers after the EMA beyond (1 - momentum) times it, and the center.
    The checks of chip_smoke.py phase 10 (a), at 1e-5, 1e-5, 1e-2 * lr, 1e-2 * lr and 1e-6."""
    from m3l_tpu_torch.kernels import MASKED_LAUNCHES
    from m3l_tpu_torch.models.vit import VisionTransformer
    from m3l_tpu_torch.ssl import DINOModule

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the patch conv in f32, as on the CPU
    try:
        torch.manual_seed(0)
        vit = VisionTransformer(img_size=(64, 64), patch_size=8, in_chans=6, embed_dim=128, depth=2, num_heads=2,
                                pos_embed_fn="sinusoidal", num_register_tokens=1)
        cpu = DINOModule(vit, dino_out_dim=256, dino_hidden_dim=128, dino_bottleneck_dim=64, warmup_epochs=0,
                         moving_average_decay=(0.99, 1.0))
        gpu = copy.deepcopy(cpu).to(card)
        x = torch.rand(4, 64, 64, 6, generator=torch.Generator().manual_seed(1))
        masks = cpu.sample_masks(torch.Generator().manual_seed(2), 4)
        results = []
        for m, dev in ((gpu, card), (cpu, torch.device("cpu"))):
            m.setup_schedules(2, 2)
            m.sample_masks = lambda g, b, dev=dev: tuple(k.to(dev) for k in masks)
            opt = m.configure_optimizer(2, 2)
            start, masked0 = Counter(LAUNCHES), Counter(MASKED_LAUNCHES)
            loss, aux = m.training_loss({"image": x.to(dev)}, None, 0)
            loss.backward()
            grads = {n: p.grad.detach().cpu().clone() for n, p in m.trainable_parameters().items()}
            opt.step()
            m.on_train_batch_end(aux, 0)
            launched = {k: (LAUNCHES[k] - start[k], MASKED_LAUNCHES[k] - masked0[k]) for k in (KERNEL, BWD_KERNEL)}
            results.append((loss.item(), grads, {n: v.detach().cpu() for n, v in m.state_dict().items()}, launched, opt))
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    (la, ga, sa, launched, opt), (lb, gb, sb, _, _) = results
    assert launched == {KERNEL: (10, 6), BWD_KERNEL: (6, 4)}
    assert abs(la - lb) <= 1e-5 * abs(lb)
    lr, eps, momentum = opt.learning_rate(0), 1e-8, cpu._momentum_fn(0)
    implied = {}
    for name, g in gb.items():
        a = ga[name]
        assert (a - g).norm() <= 1e-5 * g.norm(), name
        implied[name] = lr * (a / (a.abs() + eps) - g / (g.abs() + eps)).abs()
        assert ((sa[name] - sb[name]).abs() - implied[name]).max() <= 1e-2 * lr, name
    for name in sb:
        if name.startswith("teacher_"):
            step = (1.0 - momentum) * implied["student_" + name[len("teacher_"):]]
            assert ((sa[name] - sb[name]).abs() - step).max() <= 1e-2 * lr, name
    assert (sa["center"] - sb["center"]).abs().max() <= 1e-6
