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
# register), the I-JEPA predictor (196 context + 196 mask tokens, 12 heads of 32) and the V-JEPA
# predictor (49 context + 147 target tokens, 12 heads of 32).
SSL_SHAPES = [(64, 49, 6, 64), (64, 196, 6, 64), (64, 196, 16, 32), (64, 197, 6, 64), (64, 392, 12, 32), (64, 196, 12, 32)]


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


def test_f32_vjepa_step_matches_the_cpu(card):
    """One f32 step of a small tubelet ViT + V-JEPA on the card against the same weights, batch and
    tube masks on the CPU, every attention layer on the kernels without a key mask: the loss and
    its two parts, each trainable gradient relative to its norm, the parameters after AdamW beyond
    the difference of Adam's first steps that the two gradients imply, and the target encoder
    after the EMA beyond (1 - momentum) times it. The checks of chip_smoke.py phase 11 (a), at
    1e-5, 1e-5, 1e-2 * lr and 1e-2 * lr."""
    from m3l_tpu_torch.kernels import MASKED_LAUNCHES
    from m3l_tpu_torch.models.vit import VisionTransformer, vit_predictor
    from m3l_tpu_torch.ssl import VJEPAModule

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the Conv3d patch embedding in f32, as on the CPU
    try:
        torch.manual_seed(0)
        video = dict(img_size=(64, 64), patch_size=8, in_chans=3, num_frames=2, tubelet_size=2)
        vit = VisionTransformer(embed_dim=128, depth=2, num_heads=2, pos_embed_fn="sinusoidal", **video)
        cpu = VJEPAModule(vit, vit_predictor(128, embed_dim=64, depth=2, num_heads=2, **video), warmup_epochs=0, moving_average_decay=(0.99, 1.0))
        gpu = copy.deepcopy(cpu).to(card)
        x = torch.rand(4, 2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
        keeps = cpu.sample_masks(torch.Generator().manual_seed(2), 4)
        results = []
        for m, dev in ((gpu, card), (cpu, torch.device("cpu"))):
            m.setup_schedules(2, 2)
            m.sample_masks = lambda g, b, dev=dev: keeps.to(dev)
            opt = m.configure_optimizer(2, 2)
            start, masked0 = Counter(LAUNCHES), Counter(MASKED_LAUNCHES)
            loss, aux = m.training_loss({"image": x.to(dev)}, None, 0)
            loss.backward()
            grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().clone() for n, p in m.trainable_parameters().items()}
            opt.step()
            m.on_train_batch_end(aux, 0)
            launched = {k: (LAUNCHES[k] - start[k], MASKED_LAUNCHES[k] - masked0[k]) for k in (KERNEL, BWD_KERNEL)}
            parts = {k: aux[k].item() for k in ("loss", "loss_jepa", "loss_reg")}
            results.append((parts, grads, {n: v.detach().cpu() for n, v in m.state_dict().items()}, launched, opt))
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    (la, ga, sa, launched, opt), (lb, gb, sb, _, _) = results
    assert launched == {KERNEL: (6, 0), BWD_KERNEL: (4, 0)}
    for k in lb:
        assert abs(la[k] - lb[k]) <= 1e-5 * abs(lb[k]), k
    lr, eps, momentum = opt.learning_rate(0), 1e-8, cpu._momentum_fn(0)
    implied = {}
    for name, g in gb.items():
        a = ga[name]
        assert (a - g).norm() <= 1e-5 * g.norm(), name
        implied[name] = lr * (a / (a.abs() + eps) - g / (g.abs() + eps)).abs()
        assert ((sa[name] - sb[name]).abs() - implied[name]).max() <= 1e-2 * lr, name
    for name in sb:
        if name.startswith("target_encoder."):
            step = (1.0 - momentum) * implied["context_encoder." + name[len("target_encoder."):]]
            assert ((sa[name] - sb[name]).abs() - step).max() <= 1e-2 * lr, name


@pytest.mark.parametrize("train_encoder", [False, True], ids=["frozen", "finetuned"])
def test_f32_probe_step_matches_the_cpu(card, train_encoder):
    """One f32 ForceSLModule step over a small ViT on the card against the same weights and batch on
    the CPU: the loss, each trainable gradient relative to its norm, the parameters after AdamW
    beyond the implied Adam step difference; frozen, the encoder launches no backward and stays
    bit for bit. The checks of chip_smoke.py phase 11 (f), at 1e-5, 1e-5 and 1e-2 * lr."""
    from m3l_tpu_torch.models.vit import VisionTransformer
    from m3l_tpu_torch.tasks import ForceLinearProbe, ForceSLModule

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.manual_seed(0)
        vit = VisionTransformer(img_size=(64, 64), patch_size=8, in_chans=6, embed_dim=128, depth=2, num_heads=2, pos_embed_fn="sinusoidal")
        cpu = ForceSLModule(vit, ForceLinearProbe(128, num_heads=4), train_encoder=train_encoder, warmup_epochs=0)
        gpu = copy.deepcopy(cpu).to(card)
        gen = torch.Generator().manual_seed(1)
        batch = {"image": torch.rand(4, 64, 64, 6, generator=gen), "force": torch.rand(4, 3, generator=gen) * 2 - 1,
                 "force_scale": torch.tensor([[5.0, 5.0, 10.0]]).repeat(4, 1)}
        before = {k: v.clone() for k, v in gpu.model_encoder.state_dict().items()}
        results = []
        for m, dev in ((gpu, card), (cpu, torch.device("cpu"))):
            opt = m.configure_optimizer(2, 2)
            start = Counter(LAUNCHES)
            loss, _ = m.training_loss({k: v.to(dev) for k, v in batch.items()}, None, 0)
            loss.backward()
            grads = {n: p.grad.detach().cpu().clone() for n, p in m.trainable_parameters().items()}
            opt.step()
            launched = {k: LAUNCHES[k] - start[k] for k in (KERNEL, BWD_KERNEL)}
            results.append((loss.item(), grads, {n: v.detach().cpu() for n, v in m.state_dict().items()}, launched, opt))
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    (la, ga, sa, launched, opt), (lb, gb, sb, _, _) = results
    assert launched == {KERNEL: 2, BWD_KERNEL: 2 if train_encoder else 0}
    assert all(torch.equal(v, before[k]) for k, v in gpu.model_encoder.state_dict().items()) != train_encoder
    assert abs(la - lb) <= 1e-5 * abs(lb)
    lr, eps = opt.learning_rate(0), 1e-8
    for name, g in gb.items():
        a = ga[name]
        assert (a - g).norm() <= 1e-5 * g.norm(), name
        implied = lr * (a / (a.abs() + eps) - g / (g.abs() + eps)).abs()
        assert ((sa[name] - sb[name]).abs() - implied).max() <= 1e-2 * lr, name


def _step_on(m, dev, batch, generator=None):
    """One optimizer step of the SSL module ``m`` on ``dev``: (loss, launches, trainable gradients,
    the state after AdamW, the optimizer)."""
    opt = m.configure_optimizer(2, 2)
    start = Counter(LAUNCHES)
    loss, _ = m.training_loss({k: v.to(dev) for k, v in batch.items()}, generator, 0)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().clone() for n, p in m.trainable_parameters().items()}
    opt.step()
    launched = {k: LAUNCHES[k] - start[k] for k in (KERNEL, BWD_KERNEL)}
    return loss.item(), launched, grads, {n: v.detach().cpu() for n, v in m.state_dict().items()}, opt


def _assert_step_close(card_step, cpu_step, loss_rel, grad_rel):
    (la, _, ga, sa, opt), (lb, _, gb, sb, _) = card_step, cpu_step
    assert abs(la - lb) <= loss_rel * abs(lb)
    lr, eps = opt.learning_rate(0), 1e-8
    for name, g in gb.items():
        a = ga[name]
        assert (a - g).norm() <= grad_rel * g.norm() + 1e-12, name
        implied = lr * (a / (a.abs() + eps) - g / (g.abs() + eps)).abs()
        assert ((sa[name] - sb[name]).abs() - implied).max() <= 1e-2 * lr, name


def test_ssim_and_its_gradient_match_the_cpu(card):
    """The force-field SSIM map and its gradient on the card against the CPU, in f64 so that only
    the arithmetic's order can differ (1e-10). ``F.avg_pool2d``'s backward on the card, on the
    channels-last view of NHWC images, gave gradients 30% of their norm away from the CPU's; the
    window mean is a sum of shifted slices."""
    from m3l_tpu_torch.tasks.forcefield import ssim

    gen = torch.Generator().manual_seed(0)
    a = torch.rand(2, 24, 20, 3, generator=gen, dtype=torch.float64)
    b = (a + 0.05 * torch.rand(2, 24, 20, 3, generator=gen, dtype=torch.float64)).clamp(0, 1)
    grads = []
    for dev in (card, torch.device("cpu")):
        x = a.to(dev).requires_grad_()
        out = ssim(x, b.to(dev))
        out.pow(2).sum().backward()
        grads.append((out.detach().cpu(), x.grad.cpu()))
    (out_card, g_card), (out_cpu, g_cpu) = grads
    assert (out_card - out_cpu).abs().max() <= 1e-10
    assert (g_card - g_cpu).norm() <= 1e-10 * g_cpu.norm()


def _step_errors(a, b):
    """(loss error relative to the loss, the largest gradient error relative to its norm, the largest
    parameter error after AdamW relative to lr beyond the implied Adam step difference) of step
    ``a`` against step ``b``."""
    (la, _, ga, sa, opt), (lb, _, gb, sb, _) = a, b
    lr, eps = opt.learning_rate(0), 1e-8
    grad_rel = param = 0.0
    for name, g in gb.items():
        x = ga[name]
        if g.norm() > 0:
            grad_rel = max(grad_rel, ((x - g).norm() / g.norm()).item())
        implied = lr * (x / (x.abs() + eps) - g / (g.abs() + eps)).abs()
        param = max(param, ((sa[name] - sb[name]).abs() - implied).max().item() / lr)
    return abs(la - lb) / abs(lb), grad_rel, param


@pytest.mark.parametrize("train_encoder", [False, True], ids=["frozen", "finetuned"])
def test_f32_forcefield_step_matches_the_cpu(card, train_encoder):
    """One f32 GeometricForceFieldModule step (ViT at dim 64, depth 2, 64 x 64 x 6, patch 8; fusion
    16; the pose ResNet-18) on synthetic gel windows, on the card against the CPU, cuDNN's TF32 off:
    the loss at 2e-5 relative, gradients at 2e-4 of their norm, parameters at 1e-2 * lr beyond the
    implied Adam step. On the H100 these seeds gave 1.802e-6, 1.655e-5 and 1.185e-3, frozen and
    fine-tuned alike; the bounds are ~10x that. The reprojection's SSIM (E[x^2] - E[x]^2 over smooth
    frames) is ill-conditioned in f32 on any device, and the pose and disparity gradients reach the
    loss through it: the CPU's own f32 step lies 1.3e-4 of the gradients' norm from the
    same step with its SSIM in f64, below the gradient bound. Frozen, 2 x depth forward launches and
    no backward."""
    from m3l_tpu_torch.data import forcefield_windows, synth_digit_trajectories
    from m3l_tpu_torch.models.vit import VisionTransformer
    from m3l_tpu_torch.train.builders import build_forcefield_module
    from m3l_tpu_torch.utils.device import f32_numerics

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    f32_numerics("float32")
    try:
        torch.manual_seed(0)
        vit = VisionTransformer(img_size=(64, 64), patch_size=8, in_chans=6, embed_dim=64, depth=2, num_heads=2, pos_embed_fn="sinusoidal")
        cpu = build_forcefield_module(vit, hooks=(0, 1), fusion_ch=16, train_encoder=train_encoder, warmup_epochs=0,
                                      with_sl_supervision=True, with_mask_supervision=True)
        gpu = copy.deepcopy(cpu).to(card)
        w = forcefield_windows(synth_digit_trajectories(1, 5, size=64, seed=1))
        batch = {k: torch.from_numpy(w[k][:4]) for k in ("image", "image_bg", "mask", "force")}
        before = {k: v.clone() for k, v in gpu.model_task.encoder.state_dict().items()}
        card_step = _step_on(gpu, card, batch)
        cpu_step = _step_on(cpu, torch.device("cpu"), batch)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    assert card_step[1] == {KERNEL: 4, BWD_KERNEL: 4 if train_encoder else 0}
    assert all(torch.equal(v, before[k]) for k, v in gpu.model_task.encoder.state_dict().items()) != train_encoder
    errs = _step_errors(card_step, cpu_step)
    for err, bound in zip(errs, (2e-5, 2e-4, 1e-2)):
        assert err <= bound, errs


def test_f32_vtdino_step_matches_the_cpu(card):
    """One f32 VTDINO step (the multimodal VTT at dim 64, depth 2, 28 x 28 at patch 14, the probe) on
    the card against the CPU under the same masks: the loss at 1e-5, gradients at 1e-5 of their
    norm; 4 x depth + 2 forward and 2 x depth + 2 backward launches."""
    from m3l_tpu_torch.models import MultimodalVTT
    from m3l_tpu_torch.ssl import VTDINOModule

    torch.manual_seed(0)
    cpu = VTDINOModule(MultimodalVTT(image_size=(28, 28), tactile_size=(28, 28), dim=64, depth=2, heads=2, mlp_dim=128),
                       dino_out_dim=256, dino_hidden_dim=64, dino_bottleneck_dim=32, with_reconstruction_probe=True, warmup_epochs=0)
    masks = cpu.sample_masks(torch.Generator().manual_seed(2), 4)
    gpu = copy.deepcopy(cpu).to(card)
    for m, dev in ((gpu, card), (cpu, torch.device("cpu"))):
        m.sample_masks = lambda generator, batch, dev=dev: tuple(x.to(dev) for x in masks)
    gen = torch.Generator().manual_seed(3)
    batch = {k: torch.rand(4, 28, 28, 3, generator=gen) for k in ("image", "tactile1", "tactile2")}
    card_step = _step_on(gpu, card, batch)
    cpu_step = _step_on(cpu, torch.device("cpu"), batch)
    assert card_step[1] == {KERNEL: 10, BWD_KERNEL: 6}
    _assert_step_close(card_step, cpu_step, 1e-5, 1e-5)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "factored"])
def test_f32_multimodal_transformer_matches_the_cpu(card, shared):
    """The multimodal transformer forward and backward on the card against the CPU: outputs at 1e-5
    absolute, each gradient at 1e-5 of its norm; one forward and one backward launch a block. The
    register tokens start at zero, where the first LayerNorm's input has no variance and its
    backward divides by sqrt(eps) = 1e-3, magnifying f32 rounding a thousandfold on any device: the
    test draws them at random first. The backward takes a cotangent drawn from the seed, as
    chip_smoke.py phase 12 (e) does: under the loss sum(out^2) the register token's gradient, which
    reaches the loss only through attention, is a sum of cancelling terms ~1e-4 of the others' size,
    and f32 rounding alone put it 1.2e-2 of its norm from the CPU's on the H100."""
    from m3l_tpu_torch.models import MultimodalTransformer

    torch.manual_seed(0)
    cpu = MultimodalTransformer([48, 32], [64, 32], 128, depth=2, num_heads=2, num_register_tokens=1, shared_attn=shared)
    with torch.no_grad():
        cpu.register_tokens.normal_()
    gpu = copy.deepcopy(cpu).to(card)
    gen = torch.Generator().manual_seed(1)
    xs = [torch.randn(4, 64, 48, generator=gen), torch.randn(4, 32, 32, generator=gen)]
    cot = torch.randn(4, 96, 128, generator=gen)
    start = Counter(LAUNCHES)
    out = gpu([x.to(card) for x in xs])
    (out * cot.to(card)).sum().backward()
    launched = {k: LAUNCHES[k] - start[k] for k in (KERNEL, BWD_KERNEL)}
    ref = cpu(xs)
    (ref * cot).sum().backward()
    n = 2 if shared else 4
    assert launched == {KERNEL: n, BWD_KERNEL: n}
    assert (out.cpu() - ref).abs().max() <= 1e-5
    for (name, a), b in zip(gpu.named_parameters(), cpu.parameters()):
        assert (a.grad.cpu() - b.grad).norm() <= 1e-5 * b.grad.norm(), name


# --------------------------------------------------------------------------------------------- #
# the m3l:: operators on the card, and a torch.export artifact exported on the CPU run there
# --------------------------------------------------------------------------------------------- #
OPERATORS = ["flash_attention_qkv", "flash_attention_qkv_bwd", "flash_attention", "flash_attention_bwd"]


def operator_args(card, name: str, masked: bool):
    """Small f32 arguments of each operator on the card: batch 2, N 10, 2 heads of 8 (v1: 4 x 10 x 8)."""
    g = torch.Generator(device=card).manual_seed(0)
    grad = not name.endswith("bwd")
    if name.startswith("flash_attention_qkv"):
        qkv = torch.randn(2, 10, 48, generator=g, device=card).requires_grad_(grad)
        bias = fa._key_bias(torch.rand(2, 10, generator=g, device=card) > 0.3) if masked else None
        return (qkv, bias, 2, 8**-0.5) if grad else (qkv, bias, torch.randn(2, 10, 16, generator=g, device=card), 2, 8**-0.5)
    q, k, v = (torch.randn(4, 10, 8, generator=g, device=card).requires_grad_(grad) for _ in range(3))
    bias = fa._key_bias(torch.rand(4, 10, generator=g, device=card) > 0.3) if masked else None
    return (q, k, v, bias, 8**-0.5) if grad else (q, k, v, bias, torch.randn(4, 10, 8, generator=g, device=card), 8**-0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", OPERATORS)
def test_opcheck_on_the_card(card, name, masked):
    """The operators' CUDA implementations against their fake ones and autograd formulas (the
    backward operators have none of their own: the kernels are differentiated once)."""
    from torch.library import opcheck

    no_autograd = dict(test_utils=("test_schema", "test_faketensor", "test_aot_dispatch_dynamic"))
    opcheck(getattr(torch.ops.m3l, name).default, operator_args(card, name, masked), **(no_autograd if name.endswith("bwd") else {}))


@pytest.mark.cuda
def test_artifact_exported_on_the_cpu_launches_the_kernel_on_the_card(card, tmp_path):
    import numpy as np

    from m3l_tpu_torch import serve
    from m3l_tpu_torch.kernels import reset_launches
    from m3l_tpu_torch.models import VTTConfig

    torch.manual_seed(0)
    cfg = VTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=1)
    policy = serve.build_policy(cfg, decoder_depth=2, decoder_heads=2, dtype=torch.float32, device="cpu")
    obs = serve.random_obs(np.random.default_rng(0), 2, frame_stack=1)
    path = str(tmp_path / "policy.pt2")
    serve.save_artifact(path, serve.export_policy(policy, obs, action_low=[-1.0] * 3, action_high=[1.0] * 3))
    program = serve.load_artifact(path, device=card)
    assert sum(str(n.target) == "m3l.flash_attention_qkv.default" for n in program.graph.nodes) == 3
    server = serve.PolicyServer(copy.deepcopy(policy).to(card), action_low=[-1.0] * 3, action_high=[1.0] * 3)
    reset_launches()
    with torch.inference_mode():
        got = program.module()(server.to_device(obs)).cpu().numpy()
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {KERNEL: 3}
    np.testing.assert_allclose(got, server(obs), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_export_policy_on_another_device_than_the_policys(card):
    """``device=`` exports a copy of the policy there (JAX's ``platforms``); the policy stays put."""
    import numpy as np

    from m3l_tpu_torch import serve
    from m3l_tpu_torch.models import VTTConfig

    torch.manual_seed(0)
    cfg = VTTConfig(dim=64, depth=1, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=1)
    policy = serve.build_policy(cfg, decoder_depth=1, decoder_heads=2, dtype=torch.float32, device=card)
    obs = serve.random_obs(np.random.default_rng(1), 2, frame_stack=1)
    program = serve.export_policy(policy, obs, device="cpu")
    assert policy.log_std.device.type == "cuda"
    with torch.inference_mode():
        got = program.module()({k: torch.as_tensor(v) for k, v in obs.items()}).numpy()
    cpu = serve.PolicyServer(copy.deepcopy(policy).to("cpu"))
    np.testing.assert_array_equal(got, cpu(obs))


@pytest.mark.cuda
def test_slip_force_probe_on_a_mesh_of_ranks_sharing_the_card(card, tmp_path, monkeypatch):
    """The fine-tuned slip-with-force probe (class weights, a 64-wide ViT of depth 2 on 32 x 32) for
    two Trainer steps on four ranks sharing the card over gloo (dp 2 x mp 2) against the single
    process on the card, f32 with TF32 off: each step's loss and scalars (rtol 1e-5), each
    parameter's AdamW moments (6e-5 of their norm), the parameters (0.02 lr per element, 2e-3 of the
    single process's update of each; the key part of each attention bias 4 lr) as
    tests/test_torch_mesh_tasks.py holds them on the CPU; every rank's attention calls at half the
    rows and heads and its launches the single process's."""
    import numpy as np

    from m3l_tpu_torch.train import mesh_workers as mw
    from m3l_tpu_torch.train.mesh import launch

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    vit = dict(_target_="m3l_tpu_torch.models.vit.VisionTransformer", img_size=(32, 32), patch_size=8, in_chans=3, embed_dim=64, depth=2,
               num_heads=2, pos_embed_fn="sinusoidal")
    rng = np.random.default_rng(0)
    batches = [{"image": rng.random((8, 32, 32, 3), dtype=np.float32), "force": rng.uniform(-1, 1, (8, 3)).astype(np.float32),
                "slip": rng.integers(0, 2, 8)} for _ in range(2)]
    case = dict(encoder=vit, probe=("SlipForceProbe", dict(num_heads=2)), dtype="float32", batches=batches, epochs=1,
                module=("SlipSLModule", dict(class_weights=[1.0, 3.0], use_force=True, train_encoder=True, base_lr=1e-3, warmup_epochs=0)))
    torch.manual_seed(0)
    case["init"] = mw.task_module(dict(case, init=None)).state_dict()
    ranks = [r[0][0] for r in launch(mw.jobs_rank, [(mw.task_rank, (case, 4, 2, "cuda"))], world=4, device="cuda", timeout=300)]
    with mw.AttentionLog(card) as log:
        _, module, steps, moments = mw.task_fit(case, device=card)
    torch.cuda.synchronize()
    assert all(r["replicated"] and r["steps"] == ranks[0]["steps"] for r in ranks)
    for got, want in zip(ranks[0]["steps"], steps):
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    readings = mw.ssl_readings(module, 2, 1, ranks[0]["moments"], ranks[0]["state"], moments, module.state_dict(), case["init"])
    tol = dict(moment_rel=6e-5, param_per_lr=0.02, update_rel=2e-3, key_bias_per_lr=4.0)
    assert all(readings[k] <= bound for k, bound in tol.items()), readings
    want_calls = {(kind, b // 2, h // 2): n for (kind, b, h), n in log.calls.items()}
    assert all(r["attention"] == want_calls and r["launches"] == log.counts["launches"] for r in ranks), (ranks[0], log.counts)


def _dino_on_the_card():
    from m3l_tpu_torch.models.vit import VisionTransformer
    from m3l_tpu_torch.ssl import DINOModule

    vit = VisionTransformer(img_size=(64, 64), patch_size=8, in_chans=6, embed_dim=128, depth=2, num_heads=2, pos_embed_fn="sinusoidal",
                            num_register_tokens=1)
    module = DINOModule(vit, dino_out_dim=256, dino_hidden_dim=128, dino_bottleneck_dim=64, moving_average_decay=(0.99, 1.0))
    return module, {"image": torch.randint(0, 255, (4, 64, 64, 6), dtype=torch.uint8).numpy()}, None


def _vjepa_on_the_card():
    from m3l_tpu_torch.train.builders import build_vit, build_vjepa

    vit = build_vit("tiny", patch_size=8, img_size=(32, 32), in_chans=3, num_register_tokens=0, num_frames=4, depth=2, init_values=None,
                    compute_dtype="bfloat16")
    generators = [dict(num_blocks=8, spatial_scale=(0.15, 0.15), aspect_ratio=(0.75, 1.5)),
                  dict(num_blocks=2, spatial_scale=(0.7, 0.7), aspect_ratio=(0.75, 1.5))]
    module = build_vjepa(vit, predictor_depth=2, predictor_dim=48, predictor_num_heads=2, predictor_init_values=None,
                         predictor_compute_dtype="bfloat16", zero_init_mask_tokens=True, mask_generators=generators,
                         moving_average_decay=(0.998, 1.0), loss_exp=1.0, reg_coeff=0.0)
    return module, {"image": torch.randint(0, 255, (4, 4, 32, 32, 3), dtype=torch.uint8).numpy()}, 10.0


@pytest.mark.parametrize("build", [_dino_on_the_card, _vjepa_on_the_card], ids=["dino", "vjepa_multiblock"])
def test_ssl_train_step_never_waits_for_the_card(card, build):
    """A Trainer step of DINO (the probe on, block key masks) and of V-JEPA (two multi-block mask
    generators, bf16, the clip) makes no call that synchronises the host with the card: the second
    step, after a warm-up step on the same placed batch, runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any such call."""
    from m3l_tpu_torch.train import Trainer

    torch.manual_seed(0)
    module, batch, clip = build()
    trainer = Trainer(max_epochs=1, verbose=0, device=card)
    module.to(card)
    module.setup_schedules(2, 1)
    optimizer = module.configure_optimizer(2, 1)
    if clip is not None:
        optimizer.clip_norms = (clip, *optimizer.clip_norms)
    placed = trainer._place(batch)
    trainer.train_step(module, optimizer, placed)
    trainer.global_step += 1
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = trainer.train_step(module, optimizer, placed)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert torch.isfinite(loss)
