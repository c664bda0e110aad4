"""Each module of the port's serving slice against its JAX counterpart on the CPU.

Inputs come from numpy with a seed; weights are the JAX module's own, carried over by
load_jax_params. Everything runs in f32. The bar is rtol 1e-5 (atol 1e-5 for values near 0),
relaxed to 2e-4 where convolutions are on the path: XLA's and oneDNN's CPU convolutions sum
their 48-768 products per output in different orders and blockings, and the error grows
through the following layers (the same bound tests/test_torch_parity.py:121 uses).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from m3l_tpu.models import VTT as JVTT, VTMAE as JVTMAE, VTTConfig as JVTTConfig
from m3l_tpu.nn.early_cnn import EarlyCNN as JEarlyCNN
from m3l_tpu.nn.transformer import Transformer as JTransformer
from m3l_tpu.ops.patches import patchify as jpatchify
from m3l_tpu.ops.posenc import sincos_2d as jsincos_2d
from m3l_tpu.utils.obs import vt_load as jvt_load
from m3l_tpu_torch.models import VTT, VTMAE, VTTConfig
from m3l_tpu_torch.nn import EarlyCNN, Transformer
from m3l_tpu_torch.ops import patchify, sincos_2d, unpatchify
from m3l_tpu_torch.utils import vt_load
from m3l_tpu_torch.utils.convert import load_jax_params

CONV_TOL = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


def flat_params(module) -> dict:
    out = {}
    for path, var in nnx.to_flat_state(nnx.state(module, nnx.Param)):
        out["/".join(str(p) for p in path)] = np.asarray(var.get_value() if hasattr(var, "get_value") else var)
    return out


def raw_obs(batch, frame_stack, seed, image_dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if image_dtype == np.uint8:
        image = rng.integers(0, 256, (batch, frame_stack, 64, 64, 3), dtype=np.uint8)
    else:
        image = rng.random((batch, frame_stack, 64, 64, 3), dtype=np.float32)
    return {"image": image, "tactile": rng.uniform(-1, 1, (batch, frame_stack, 6, 32, 32)).astype(np.float32)}


@pytest.mark.parametrize("frame_stack,image_dtype", [(1, np.uint8), (4, np.uint8), (4, np.float32)])
def test_vt_load_matches_jax(frame_stack, image_dtype):
    obs = raw_obs(2, frame_stack, seed=frame_stack, image_dtype=image_dtype)
    obs["tactile3"] = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ref = jvt_load(obs, frame_stack=frame_stack)
    out = vt_load({k: torch.from_numpy(v) for k, v in obs.items()}, frame_stack=frame_stack)
    assert sorted(out) == sorted(ref) == ["image", "tactile1", "tactile2", "tactile3"]
    for k in ref:
        assert out[k].dtype == torch.float32
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


def test_vt_load_rejects_wrong_channel_count():
    with pytest.raises(ValueError, match="image channels"):
        vt_load({"image": torch.zeros(1, 64, 64, 6, dtype=torch.uint8)}, frame_stack=1)
    with pytest.raises(ValueError, match="tactile channels"):
        vt_load({"tactile": torch.zeros(1, 7, 32, 32)}, frame_stack=1)


@pytest.mark.parametrize("shape,patch", [((2, 64, 64, 12), 8), ((3, 32, 32, 3), 4)])
def test_patchify_matches_jax_and_round_trips(shape, patch):
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    p = patchify(torch.from_numpy(x), patch, patch)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jpatchify(jnp.asarray(x), patch, patch)))
    g = shape[1] // patch
    np.testing.assert_array_equal(unpatchify(p, g, g, patch, patch, shape[3]).numpy(), x)


@pytest.mark.parametrize("h,w,c", [(8, 8, 256), (8, 8, 64), (4, 4, 30), (3, 5, 7)])
def test_sincos_2d_equals_jax(h, w, c):
    out = sincos_2d(h, w, c)
    assert out.dtype == np.float32 and out.shape == (h * w, c)
    np.testing.assert_array_equal(out, np.asarray(jsincos_2d(h, w, c)))


@pytest.mark.parametrize("kind,size,channels", [("image", 64, 12), ("tactile", 32, 3)])
def test_early_cnn_matches_jax(kind, size, channels):
    jm = JEarlyCNN(channels, 64, kind=kind, rngs=nnx.Rngs(1))
    tm = EarlyCNN(channels, 64, kind=kind)
    load_jax_params(tm, flat_params(jm))
    x = np.random.default_rng(2).random((2, size, size, channels), dtype=np.float32)
    out = tm(torch.from_numpy(x))
    assert out.shape == (2, 64, 64)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jm(jnp.asarray(x))), **CONV_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_transformer_matches_jax(masked):
    jm = JTransformer(64, 2, 2, 32, 128, rngs=nnx.Rngs(3))
    tm = Transformer(64, 2, 2, 32, 128)
    load_jax_params(tm, flat_params(jm))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    mask = (rng.uniform(size=(2, 24)) > 0.4) | (np.arange(24) == 0) if masked else None
    ref = jm(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        out = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("early_conv,sincosmod", [(True, True), (False, True), (False, False)])
def test_vtmae_get_embeddings_matches_jax(early_conv, sincosmod):
    kw = dict(decoder_dim=64, masking_ratio=0.95, decoder_depth=2, decoder_heads=2,
              early_conv_masking=early_conv, use_sincosmod_encodings=sincosmod)
    jcfg = JVTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=2)
    jm = JVTMAE(JVTT(jcfg, rngs=nnx.Rngs(0)), rngs=nnx.Rngs(0), **kw)
    tm = VTMAE(VTT(VTTConfig(dim=64, depth=2, heads=2, mlp_dim=128, num_tactiles=2, frame_stack=2)), **kw)
    load_jax_params(tm, flat_params(jm))
    obs = raw_obs(2, 2, seed=6)
    ref = jm.get_embeddings(jvt_load(obs, frame_stack=2))
    with torch.no_grad():
        out = tm.get_embeddings(vt_load({k: torch.from_numpy(v) for k, v in obs.items()}, frame_stack=2))
    assert out.shape == (2, 192, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **(CONV_TOL if early_conv else TOL))
