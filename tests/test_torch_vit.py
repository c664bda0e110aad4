"""The port's ViT layers and zoo (nn/vit_layers.py, models/vit.py, ops/posenc.py sincos_nd)
against the JAX package on the CPU.

Inputs come from numpy with a seed; weights are the JAX module's own, carried over by
load_jax_params. Everything runs in f32: rtol 1e-5, or 2e-4 where the patch conv is on the path.
The JAX Attention takes its einsum path on the CPU, the port's its plain attention.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jax_params import CONV_TOL, TOL, carry, images, t, vit_pair
from m3l_tpu.nn import vit_layers as jl
from m3l_tpu.ops.posenc import sincos_nd as jsincos_nd
from m3l_tpu_torch.models import vit as tvit
from m3l_tpu_torch.nn import vit_layers as tl
from m3l_tpu_torch.ops.posenc import sincos_nd
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def close(out, ref, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)


def key_mask(b, n, seed):
    m = np.random.default_rng(seed).random((b, n)) > 0.4
    m[:, 0] = True
    return m


@pytest.mark.parametrize("grid,dim", [((4, 4), 64), ((14, 14), 384), ((2, 3, 5), 64), ((3, 5), 30), ((7,), 10)])
def test_sincos_nd_equals_jax(grid, dim):
    out = sincos_nd(grid, dim)
    assert out.dtype == np.float32 and out.shape == (int(np.prod(grid)), dim)
    np.testing.assert_array_equal(out, np.asarray(jsincos_nd(grid, dim)))


@pytest.mark.parametrize("name", ["mlp", "swiglu"])
def test_ffn_layers(name):
    x = images((2, 5, 32), seed=1)
    if name == "mlp":
        j, p = jl.Mlp(32, 96, rngs=nnx.Rngs(0)), tl.Mlp(32, 96)
    else:
        j, p = jl.SwiGLUFFN(32, 96, rngs=nnx.Rngs(0)), tl.SwiGLUFFN(32, 96)
        assert p.hidden == j.hidden == 64
    close(carry(j, p)(t(x)), j(jnp.asarray(x)))


def test_layer_scale_and_drop_path():
    j = jl.LayerScale(16, 0.1, rngs=nnx.Rngs(0))
    p = carry(j, tl.LayerScale(16, 0.1))
    x = images((3, 4, 16))
    close(p(t(x)), j(jnp.asarray(x)))
    assert p(t(x).to(torch.bfloat16)).dtype == torch.bfloat16  # gamma is cast to x's dtype
    xt = t(images((64, 4, 8)))
    assert tl.drop_path(xt, 0.0, torch.Generator()) is xt and tl.drop_path(xt, 0.5, None) is xt
    out = tl.drop_path(xt, 0.25, torch.Generator().manual_seed(0))
    kept = (out != 0).flatten(1).all(1)
    assert ((out == 0).flatten(1).all(1) | kept).all()  # whole samples are dropped or kept
    torch.testing.assert_close(out[kept], xt[kept] / 0.75)
    assert 0 < int((~kept).sum()) < 64


@pytest.mark.parametrize("masked", [False, True])
def test_attention(masked):
    j = jl.Attention(64, 2, rngs=nnx.Rngs(0))
    p = carry(j, tl.Attention(64, 2))
    x = images((2, 9, 64), seed=2)
    km = key_mask(2, 9, 3) if masked else None
    close(p(t(x), None if km is None else t(km)), j(jnp.asarray(x), None if km is None else jnp.asarray(km)))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_and_block(masked):
    q, kv = images((2, 7, 64), seed=4), images((2, 5, 64), seed=5)
    km = key_mask(2, 5, 6) if masked else None
    jkm, tkm = (None, None) if km is None else (jnp.asarray(km), t(km))
    j = jl.CrossAttention(64, 2, rngs=nnx.Rngs(0))
    close(carry(j, tl.CrossAttention(64, 2))(t(q), t(kv), tkm), j(jnp.asarray(q), jnp.asarray(kv), jkm))
    jb = jl.CrossAttentionBlock(64, 2, mlp_ratio=2.0, rngs=nnx.Rngs(1))
    close(carry(jb, tl.CrossAttentionBlock(64, 2, mlp_ratio=2.0))(t(q), t(kv), tkm), jb(jnp.asarray(q), jnp.asarray(kv), jkm))


@pytest.mark.parametrize("ffn,init_values,masked", [("mlp", 1.0, False), ("mlp", 0.1, True), ("swiglu", None, True), ("identity", 1.0, False)])
def test_block(ffn, init_values, masked):
    kw = dict(mlp_ratio=4.0, init_values=init_values, ffn_layer=ffn)
    j = jl.Block(64, 2, rngs=nnx.Rngs(0), **kw)
    p = carry(j, tl.Block(64, 2, **kw))
    x = images((2, 9, 64), seed=7)
    km = key_mask(2, 9, 8) if masked else None
    close(p(t(x), None if km is None else t(km)), j(jnp.asarray(x), None if km is None else jnp.asarray(km)))


def test_dino_head():
    j = jl.DINOHead(64, 48, hidden_dim=32, bottleneck_dim=16, nlayers=3, rngs=nnx.Rngs(0))
    p = carry(j, tl.DINOHead(64, 48, hidden_dim=32, bottleneck_dim=16, nlayers=3))
    x = images((3, 64), seed=9)
    close(p(t(x)), j(jnp.asarray(x)))
    zero = torch.zeros(2, 64, requires_grad=True)
    p(zero).sum().backward()
    assert torch.isfinite(zero.grad).all()


def test_patch_embeds():
    j = jl.PatchEmbed((32, 32), 8, 6, 64, rngs=nnx.Rngs(0))
    p = carry(j, tl.PatchEmbed((32, 32), 8, 6, 64))
    x = images((2, 32, 32, 6), seed=10)
    close(p(t(x)), j(jnp.asarray(x)), CONV_TOL)
    j3 = jl.PatchEmbed3D(4, 2, (16, 16), 8, 3, 32, rngs=nnx.Rngs(1))
    p3 = carry(j3, tl.PatchEmbed3D(4, 2, (16, 16), 8, 3, 32))
    assert p3.proj.weight.shape == (32, 3, 2, 8, 8)  # Conv3d (T, H, W, I, O) -> (O, I, T, H, W)
    v = images((2, 4, 16, 16, 3), seed=11)
    out = p3(t(v))
    assert out.shape == (2, 2 * 2 * 2, 32)
    close(out, j3(jnp.asarray(v)), CONV_TOL)


@pytest.mark.parametrize("shape", [(3, 7, 16), (7, 3, 16), (5, 9, 4)])
def test_bicubic_resize_equals_jax_up_and_down(shape):
    base = images((5, 5, shape[-1]), seed=12)
    ref = jax.image.resize(jnp.asarray(base), shape, method="bicubic")
    close(tvit.resize(t(base), shape, "bicubic"), ref)


@pytest.mark.parametrize("size", [48, 24])
def test_learned_position_table_resized_up_and_down(size):
    j, p = vit_pair(pos_embed_fn="learned", num_register_tokens=1)
    x = images((2, size, size, 3), seed=13)
    np.testing.assert_allclose(p.pos_encoding(x.shape).detach().numpy(), np.asarray(j.pos_encoding(x.shape)), **TOL)
    out, ref = p.forward_features(t(x)), j.forward_features(jnp.asarray(x))
    for k in ("x_norm_regtokens", "x_norm_patchtokens", "x_prenorm"):
        close(out[k], ref[k], CONV_TOL)


def test_sinusoidal_table_off_size():
    j, p = vit_pair()
    x = images((1, 40, 24, 3), seed=14)
    close(p.pos_encoding(x.shape), j.pos_encoding(x.shape))
    close(p(t(x)), j(jnp.asarray(x)), CONV_TOL)


@pytest.mark.parametrize("registers", [0, 2])
def test_forward_features_with_mask_indices_and_key_mask(registers):
    j, p = vit_pair(num_register_tokens=registers)
    x = images((3, 32, 32, 3), seed=15)
    idx = np.stack([np.random.default_rng(i).permutation(16)[:5] for i in range(3)])
    out, ref = p.forward_features(t(x), mask_indices=t(idx)), j.forward_features(jnp.asarray(x), mask_indices=jnp.asarray(idx))
    assert out["x_norm_patchtokens"].shape == (3, 5, 64) and out["x_norm_regtokens"].shape == (3, registers, 64)
    for k in ("x_norm_regtokens", "x_norm_patchtokens", "x_prenorm"):
        close(out[k], ref[k], CONV_TOL)
    km = key_mask(3, 16, 16)
    out, ref = p.forward_features(t(x), key_mask=t(km)), j.forward_features(jnp.asarray(x), key_mask=jnp.asarray(km))
    for k in ("x_norm_regtokens", "x_norm_patchtokens", "x_prenorm"):
        close(out[k], ref[k], CONV_TOL)
    assert out["masks"] is not None


def test_forward_features_multimask():
    j, p = vit_pair(num_register_tokens=1)
    x = images((2, 32, 32, 3), seed=17)
    kms = np.stack([key_mask(2, 16, s) for s in (18, 19, 20)])
    out, ref = p.forward_features_multimask(t(x), t(kms)), j.forward_features_multimask(jnp.asarray(x), jnp.asarray(kms))
    assert out["x_prenorm"].shape == (6, 17, 64)
    for k in ("x_norm_regtokens", "x_norm_patchtokens", "x_prenorm"):
        close(out[k], ref[k], CONV_TOL)


@pytest.mark.parametrize("n,reshape,cls", [(1, False, False), (2, True, True), ([0], False, True)])
def test_get_intermediate_layers(n, reshape, cls):
    j, p = vit_pair(num_register_tokens=1)
    x = images((2, 32, 32, 3), seed=21)
    out = p.get_intermediate_layers(t(x), n=n, reshape=reshape, return_class_token=cls)
    ref = j.get_intermediate_layers(jnp.asarray(x), n=n, reshape=reshape, return_class_token=cls)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        for a, b in (zip(o, r) if cls else [(o, r)]):
            assert tuple(a.shape) == tuple(b.shape)
            close(a, b, CONV_TOL)


def test_video_vit():
    j, p = vit_pair(num_frames=4, tubelet_size=2, img_size=(16, 16))
    x = images((2, 4, 16, 16, 3), seed=22)
    close(p(t(x)), j(jnp.asarray(x)), CONV_TOL)


def test_factories_and_bf16_tokens():
    small = tvit.vit_small(img_size=(32, 32), in_chans=6, depth=1, pos_embed_fn="sinusoidal")
    assert (small.embed_dim, small.num_heads, len(small.blocks)) == (384, 6, 1)
    assert [f(depth=1).embed_dim for f in (tvit.vit_tiny, tvit.vit_base)] == [192, 768]
    bf = tvit.vit_tiny(img_size=(32, 32), patch_size=8, depth=1, num_register_tokens=1, pos_embed_fn="sinusoidal", dtype=torch.bfloat16)
    out = bf.forward_features(t(images((2, 32, 32, 3))))
    assert out["x_prenorm"].dtype == torch.bfloat16 and bf.blocks[0].ls1.gamma.dtype == torch.float32
