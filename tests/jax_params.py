"""JAX parameters as the port's converter takes them, and the tiny SSL models both port tests
build (test helper, not a test file).

``flat_params`` flattens an nnx module's ``nnx.Param`` state by path (``blocks/0/attn/qkv/kernel``);
``_pos_table`` is ``nnx.data``, not a parameter, and is left out: the port recomputes it.
The tiny ViT is depth 2, dim 64, 2 heads x 32 on 32x32 images with patch 8 (16 patches).
"""
import numpy as np
import torch
from flax import nnx

from m3l_tpu.models.vit import VisionTransformer as JViT
from m3l_tpu.ssl import MAEModule as JMAE
from m3l_tpu_torch.models.vit import VisionTransformer
from m3l_tpu_torch.ssl import MAEModule
from m3l_tpu_torch.utils.convert import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=2e-4, atol=2e-5)  # the patch conv is on the path (see tests/test_torch_modules.py)
VIT = dict(img_size=(32, 32), patch_size=8, in_chans=3, embed_dim=64, depth=2, num_heads=2, pos_embed_fn="sinusoidal")
MAE = dict(decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=2, mask_ratio=0.75)


def flat_state(state) -> dict:
    """An nnx State (parameters, or gradients shaped like them) flattened by path."""
    out = {}
    for path, var in nnx.to_flat_state(state):
        out["/".join(str(p) for p in path)] = np.asarray(var.get_value() if hasattr(var, "get_value") else var)
    return out


def flat_params(module) -> dict:
    return flat_state(nnx.state(module, nnx.Param))


def carry(jax_module, torch_module):
    """``torch_module`` with ``jax_module``'s parameters; returns it."""
    load_jax_params(torch_module, flat_params(jax_module))
    return torch_module


def vit_pair(**kw):
    """The tiny JAX ViT and the port's with its weights."""
    cfg = {**VIT, **kw}
    return (j := JViT(rngs=nnx.Rngs(0), **cfg)), carry(j, VisionTransformer(**cfg))


def mae_pair(vit_kw=None, **kw):
    """The tiny JAX MAEModule and the port's with its weights."""
    cfg, vcfg = {**MAE, **kw}, {**VIT, **(vit_kw or {})}
    j = JMAE(JViT(rngs=nnx.Rngs(0), **vcfg), rngs=nnx.Rngs(1), **cfg)
    return j, carry(j, MAEModule(VisionTransformer(**vcfg), **cfg))


def images(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))
