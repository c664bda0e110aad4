"""Config-friendly builders, the ``_target_``s of the YAML tree (counterpart of
``m3l_tpu/train/builders.py``): plain scalars and a seed in, the port's modules out.

Each builder draws its initial weights from its own ``seed`` (torch's global generator is left as
it was). Every ``_target_`` under ``config/`` names one of them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..models import vit as vit_zoo

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _seeded(seed: int, build):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def build_vit(
    size: str = "small",
    *,
    patch_size: int = 16,
    img_size: Sequence[int] = (224, 224),
    in_chans: int = 6,
    num_register_tokens: int = 1,
    pos_embed_fn: str = "sinusoidal",
    num_frames: int = 1,
    tubelet_size: int = 2,
    depth: Optional[int] = None,
    init_values: Optional[float] = 1.0,
    compute_dtype: str = "float32",
    seed: int = 0,
):
    """The ViT of ``size``; ``init_values`` is each LayerScale's initial gamma, None for blocks
    without LayerScale (V-JEPA's ViTs)."""
    factory = getattr(vit_zoo, f"vit_{size}")
    kwargs = dict(
        img_size=tuple(img_size),
        in_chans=in_chans,
        pos_embed_fn=pos_embed_fn,
        num_frames=num_frames,
        tubelet_size=tubelet_size,
        init_values=init_values,
        dtype=_DTYPES[compute_dtype],
    )
    if depth is not None:
        kwargs["depth"] = depth
    return _seeded(seed, lambda: factory(patch_size=patch_size, num_register_tokens=num_register_tokens, **kwargs))


def build_predictor(
    encoder,
    *,
    embed_dim: int = 384,
    depth: int = 6,
    num_heads: int = 12,
    num_mask_tokens: int = 1,
    zero_init_mask_tokens: bool = False,
    init_values: Optional[float] = 1.0,
    compute_dtype: str = "float32",
    seed: int = 1,
):
    """The predictor over ``encoder``'s latents: ``depth`` blocks ``embed_dim`` wide with
    ``num_heads`` heads, ``num_mask_tokens`` mask tokens (zeros with ``zero_init_mask_tokens``),
    LayerScale as :func:`build_vit` sets it, products in ``compute_dtype``."""
    return _seeded(
        seed,
        lambda: vit_zoo.vit_predictor(
            input_dim=encoder.embed_dim,
            patch_size=encoder.patch_size,
            embed_dim=embed_dim,
            depth=depth,
            num_heads=num_heads,
            img_size=encoder.img_size,
            in_chans=encoder.in_chans,
            num_frames=encoder.num_frames,
            tubelet_size=encoder.tubelet_size,
            num_mask_tokens=num_mask_tokens,
            zero_init_mask_tokens=zero_init_mask_tokens,
            init_values=init_values,
            dtype=_DTYPES[compute_dtype],
        ),
    )


def build_mae(encoder, *, seed: int = 1, **kwargs):
    from ..ssl import MAEModule

    return _seeded(seed, lambda: MAEModule(encoder, **kwargs))


def build_dino(encoder, *, seed: int = 1, **kwargs):
    from ..ssl import DINOModule

    return _seeded(seed, lambda: DINOModule(encoder, **kwargs))


def build_dinov2(encoder, *, seed: int = 1, **kwargs):
    from ..ssl import DINOv2Module

    return _seeded(seed, lambda: DINOv2Module(encoder, **kwargs))


def build_ijepa(encoder, *, predictor_depth: int = 6, predictor_dim: int = 384, num_target_masks: int = 4, seed: int = 1, **kwargs):
    from ..ssl import IJEPAModule

    predictor = build_predictor(encoder, embed_dim=predictor_dim, depth=predictor_depth, num_mask_tokens=num_target_masks, seed=seed + 1)
    return _seeded(seed, lambda: IJEPAModule(encoder, predictor, num_target_masks=num_target_masks, **kwargs))


def build_vjepa(
    encoder,
    *,
    predictor_depth: int = 6,
    predictor_dim: int = 384,
    predictor_num_heads: int = 12,
    predictor_init_values: Optional[float] = 1.0,
    predictor_compute_dtype: str = "float32",
    zero_init_mask_tokens: bool = False,
    mask_generators: Optional[Sequence[dict]] = None,
    seed: int = 1,
    **kwargs,
):
    """V-JEPA over ``encoder``: the predictor (:func:`build_predictor`, one mask token for each of
    ``mask_generators``, else one) and the module, whose multi-block masks are seeded from ``seed``."""
    from ..ssl import VJEPAModule

    predictor = build_predictor(encoder, embed_dim=predictor_dim, depth=predictor_depth, num_heads=predictor_num_heads,
                                num_mask_tokens=len(mask_generators) if mask_generators else 1, zero_init_mask_tokens=zero_init_mask_tokens,
                                init_values=predictor_init_values, compute_dtype=predictor_compute_dtype, seed=seed + 1)
    kwargs.setdefault("mask_seed", seed)
    return _seeded(seed, lambda: VJEPAModule(encoder, predictor, mask_generators=mask_generators, **kwargs))


_PROBES = {
    "force": ("ForceLinearProbe", "ForceSLModule"),
    "slip": ("SlipProbe", "SlipSLModule"),
    "pose": ("PoseLinearProbe", "PoseSLModule"),
    "grasp": ("GraspLinearProbe", "GraspSLModule"),
    "textile": ("TextileLinearProbe", "TextileSLModule"),
}


def build_task_module(
    encoder,
    task: str,
    *,
    checkpoint_encoder: Optional[str] = None,
    encoder_type: str = "mae",
    train_encoder: bool = False,
    num_classes: Optional[int] = None,
    num_heads: int = 12,
    seed: int = 2,
    **kwargs,
):
    """The probe of ``task`` over ``encoder`` (its weights from ``seed``) in the task's SL module,
    which loads the encoder from ``checkpoint_encoder`` when given."""
    from .. import tasks

    probe_name, module_name = _PROBES[task]
    probe_kwargs = dict(num_heads=num_heads)
    if num_classes is not None:
        probe_kwargs["num_classes"] = num_classes
    probe = _seeded(seed, lambda: getattr(tasks, probe_name)(encoder.embed_dim, **probe_kwargs))
    return getattr(tasks, module_name)(
        encoder,
        probe,
        checkpoint_encoder=checkpoint_encoder,
        encoder_type=encoder_type,
        train_encoder=train_encoder,
        **kwargs,
    )


def build_forcefield_module(
    encoder,
    *,
    geometric: bool = True,
    hooks: Sequence[int] = (2, 5, 8, 11),
    fusion_ch: int = 128,
    seed: int = 2,
    **kwargs,
):
    """The force-field task over the ViT's intermediate layers: the DPT decoder (weights from
    ``seed``) in a GeometricForceFieldModule (pose estimation and depth reprojection, the pose
    network from ``seed + 1``), or in the flow-only ForceFieldModule when not ``geometric``. Hooks
    past a shallow encoder's depth are dropped (its last block when none is left)."""
    from ..tasks import ForceFieldDecoder, ForceFieldModule, GeometricForceFieldModule

    hooks = [h for h in hooks if h < len(encoder.blocks)] or [len(encoder.blocks) - 1]
    dec = _seeded(seed, lambda: ForceFieldDecoder(encoder, hooks=hooks, fusion_ch=fusion_ch))
    if geometric:
        return _seeded(seed + 1, lambda: GeometricForceFieldModule(dec, **kwargs))
    return ForceFieldModule(dec, **kwargs)


def build_trainer(**kwargs):
    from .trainer import Trainer

    return Trainer(**kwargs)
