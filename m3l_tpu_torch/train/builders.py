"""Config-friendly builders, the ``_target_``s of the YAML tree (counterpart of
``m3l_tpu/train/builders.py``): plain scalars and a seed in, the port's modules out.

Each builder draws its initial weights from its own ``seed`` (torch's global generator is left as
it was). The builders of the algorithms not ported yet (DINO, DINOv2, I-JEPA, V-JEPA, the
downstream tasks) are absent, so their config targets fail to import.
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


def build_mae(encoder, *, seed: int = 1, **kwargs):
    from ..ssl import MAEModule

    return _seeded(seed, lambda: MAEModule(encoder, **kwargs))


def build_trainer(**kwargs):
    from .trainer import Trainer

    return Trainer(**kwargs)
