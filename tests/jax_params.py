"""JAX parameters as the port's converter takes them, and the tiny SSL models the port tests
build (test helper, not a test file).

``flat_params`` flattens an nnx module's ``nnx.Param`` state by path (``blocks/0/attn/qkv/kernel``);
``flat_variables`` adds the other nnx variables (the DINO modules' ``center`` and ``ibot_center``,
which the port keeps as buffers). ``_pos_table`` is ``nnx.data``, not a variable, and is left out:
the port recomputes it. The tiny ViT is depth 2, dim 64, 2 heads x 32 on 32x32 images with patch 8
(16 patches); the DINO heads are 32 wide (hidden 48, bottleneck 16); the I-JEPA predictor is
depth 2, dim 32, 2 heads x 16. The V-JEPA models are the same ViT and predictor on two frames at
tubelet 2 (a 1 x 4 x 4 grid), one mask token. The probes pool the tiny ViT's tokens with 2 heads.
"""
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from m3l_tpu import ssl as jssl
from m3l_tpu.models.vit import VisionTransformer as JViT
from m3l_tpu.models.vit import vit_predictor as jvit_predictor
from m3l_tpu.ssl import MAEModule as JMAE
from m3l_tpu_torch import ssl as tssl
from m3l_tpu_torch.models.vit import VisionTransformer, vit_predictor
from m3l_tpu_torch.ssl import MAEModule
from m3l_tpu_torch.utils.convert import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
CONV_TOL = dict(rtol=2e-4, atol=2e-5)  # the patch conv is on the path (see tests/test_torch_modules.py)
VIT = dict(img_size=(32, 32), patch_size=8, in_chans=3, embed_dim=64, depth=2, num_heads=2, pos_embed_fn="sinusoidal")
MAE = dict(decoder_embed_dim=64, decoder_depth=1, decoder_num_heads=2, mask_ratio=0.75)
DINO = dict(dino_out_dim=32, dino_hidden_dim=48, dino_bottleneck_dim=16)
PREDICTOR = dict(patch_size=8, img_size=(32, 32), in_chans=3, embed_dim=32, depth=2, num_heads=2, num_mask_tokens=4)
VIDEO = dict(num_frames=2, tubelet_size=2)


def flat_state(state) -> dict:
    """An nnx State (parameters, or gradients shaped like them) flattened by path."""
    out = {}
    for path, var in nnx.to_flat_state(state):
        out["/".join(str(p) for p in path)] = np.asarray(var.get_value() if hasattr(var, "get_value") else var)
    return out


def flat_params(module) -> dict:
    return flat_state(nnx.state(module, nnx.Param))


def flat_variables(module) -> dict:
    """Every nnx variable of ``module`` (parameters and the non-parameter state) by path."""
    return flat_state(nnx.state(module, nnx.Variable))


def carry(jax_module, torch_module):
    """``torch_module`` with ``jax_module``'s parameters and other variables; returns it."""
    load_jax_params(torch_module, flat_variables(jax_module))
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


def dino_pair(name="DINOModule", vit_kw=None, **kw):
    """The tiny JAX DINO (or DINOv2) module and the port's with its weights; one register token."""
    cfg, vcfg = {**DINO, **kw}, {**VIT, "num_register_tokens": 1, **(vit_kw or {})}
    j = getattr(jssl, name)(JViT(rngs=nnx.Rngs(0), **vcfg), rngs=nnx.Rngs(1), **cfg)
    return j, carry(j, dino_twin(name, vit_kw, **kw))


def dino_twin(name="DINOModule", vit_kw=None, **kw):
    """A port module of the tiny DINO configuration (weights from torch's generator)."""
    return getattr(tssl, name)(VisionTransformer(**{**VIT, "num_register_tokens": 1, **(vit_kw or {})}), **{**DINO, **kw})


def ijepa_pair(**kw):
    """The tiny JAX IJEPAModule and the port's with its weights."""
    j = jssl.IJEPAModule(JViT(rngs=nnx.Rngs(0), **VIT), jvit_predictor(64, rngs=nnx.Rngs(2), **PREDICTOR), rngs=nnx.Rngs(1), **kw)
    return j, carry(j, ijepa_twin(**kw))


def ijepa_twin(**kw):
    return tssl.IJEPAModule(VisionTransformer(**VIT), vit_predictor(64, **PREDICTOR), **kw)


def vjepa_pair(**kw):
    """The tiny JAX VJEPAModule and the port's with its weights."""
    pkw = {**PREDICTOR, **VIDEO, "num_mask_tokens": 1}
    j = jssl.VJEPAModule(JViT(rngs=nnx.Rngs(0), **VIT, **VIDEO), jvit_predictor(64, rngs=nnx.Rngs(2), **pkw), rngs=nnx.Rngs(1), **kw)
    return j, carry(j, vjepa_twin(**kw))


def vjepa_twin(**kw):
    return tssl.VJEPAModule(VisionTransformer(**VIT, **VIDEO), vit_predictor(64, **{**PREDICTOR, **VIDEO, "num_mask_tokens": 1}), **kw)


def probe_pair(name: str, train_encoder: bool, probe_kw=None, **kw):
    """The tiny JAX SL module ``name`` (a probe of m3l_tpu.tasks over the tiny ViT) and the port's
    with its weights; ``probe_kw`` go to the probe, ``kw`` to the module."""
    from m3l_tpu import tasks as jtasks
    from m3l_tpu_torch import tasks as ttasks

    probe, module = PROBES[name]
    pkw = {"num_heads": 2, **(probe_kw or {})}
    jkw = dict(kw)
    pose_weights = jkw.pop("class_weights") if module == "PoseSLModule" and "class_weights" in jkw else None
    j = getattr(jtasks, module)(JViT(rngs=nnx.Rngs(0), **VIT), getattr(jtasks, probe)(64, rngs=nnx.Rngs(3), **pkw), train_encoder=train_encoder, **jkw)
    if pose_weights is not None:
        # the JAX PoseSLModule cannot take its dict of class weights in __init__ under flax >= 0.12
        # (a dict of arrays in a static attribute); set it as nnx data, as flax asks
        j.class_weights = nnx.data({k: jnp.asarray(v, jnp.float32) for k, v in pose_weights.items()})
    p = getattr(ttasks, module)(VisionTransformer(**VIT), getattr(ttasks, probe)(64, **pkw), train_encoder=train_encoder, **kw)
    return j, carry(j, p)


PROBES = {
    "force": ("ForceLinearProbe", "ForceSLModule"),
    "slip": ("SlipProbe", "SlipSLModule"),
    "slip_force": ("SlipForceProbe", "SlipSLModule"),
    "pose": ("PoseLinearProbe", "PoseSLModule"),
    "grasp": ("GraspLinearProbe", "GraspSLModule"),
    "textile": ("TextileLinearProbe", "TextileSLModule"),
}


def images(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))
