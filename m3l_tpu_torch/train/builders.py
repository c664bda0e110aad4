"""Config-friendly builders, the ``_target_``s of the YAML tree (counterpart of
``m3l_tpu/train/builders.py``): plain scalars and a seed in, the port's modules out.

Each builder draws its initial weights from its own ``seed`` (torch's global generator is left as
it was). The builders of what is not ported yet (V-JEPA and the downstream tasks) are absent, so
their config targets fail to import.
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
    compute_dtype: str = "float32",
    seed: int = 0,
):
    factory = getattr(vit_zoo, f"vit_{size}")
    kwargs = dict(
        img_size=tuple(img_size),
        in_chans=in_chans,
        pos_embed_fn=pos_embed_fn,
        num_frames=num_frames,
        tubelet_size=tubelet_size,
        dtype=_DTYPES[compute_dtype],
    )
    if depth is not None:
        kwargs["depth"] = depth
    return _seeded(seed, lambda: factory(patch_size=patch_size, num_register_tokens=num_register_tokens, **kwargs))


def build_predictor(encoder, *, embed_dim: int = 384, depth: int = 6, num_heads: int = 12, num_mask_tokens: int = 1, seed: int = 1):
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


def build_trainer(**kwargs):
    from .trainer import Trainer

    return Trainer(**kwargs)
