"""Carry JAX (flax.nnx) parameters into the port's modules.

``flat`` maps each nnx parameter path, joined with ``/`` (``features/mae/encoder/pos_embedding``,
``pi_mlp/layers/0/kernel``), to its value as a numpy array. The module path before the last
component names the torch submodule (``nnx.List`` indices become ``nn.ModuleList`` indices), and
the last component is converted by the kind of that submodule:

* ``Linear``: ``kernel`` (in, out) -> ``weight`` (out, in); ``bias`` as is;
* ``Conv2d``: ``kernel`` HWIO -> ``weight`` OIHW; ``bias`` as is;
* ``Conv3d``: ``kernel`` (T, H, W, I, O) -> ``weight`` (O, I, T, H, W); ``bias`` as is;
* ``LayerNorm``: ``scale`` -> ``weight``, ``bias`` -> ``bias``;
* ``BatchNorm2d``: ``scale`` -> ``weight``, ``bias`` -> ``bias``, and the ``nnx.BatchStat``
  ``mean`` -> ``running_mean``, ``var`` -> ``running_var``;
* ``Embedding``: ``embedding`` -> ``weight``;
* any other leaf (``log_std``, ``mask_token``, ``pos_embedding``, ``register_tokens``, a
  LayerScale's ``gamma``, a DINOHead's ``last_v`` / ``last_g``, an attentive pooler's
  ``query_tokens``, an ``nnx.List`` of parameters' ``mask_tokens/0``, an ``nn.ParameterList``
  entry here) is a parameter of that name and carries over as is;
* a leaf that names a registered buffer (the DINO modules' ``center`` and ``ibot_center``,
  non-``Param`` nnx variables in JAX) carries over into it as is.

Whole modules carry over by their paths: the V-JEPA module's ``context_encoder``, ``predictor``
and ``target_encoder``, a probe's ``pooler/cross`` block and its ``nnx.List`` heads
(``head/0/kernel`` -> ``head.0.weight``), an SL module's ``model_encoder/encoder`` and
``model_task``.

Every JAX key must be used and every torch parameter and persistent buffer set, else it raises.
The sin/cos tables (``_pos_table`` of the ViT and the SSL decoders, ``nnx.data`` in JAX) are
non-persistent buffers: the port recomputes them.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..nn.layers import BatchNorm2d


def _target(module: nn.Module, leaf: str) -> tuple[str, Callable[[np.ndarray], np.ndarray]]:
    """(torch parameter name on ``module``, numpy conversion) for a JAX leaf name."""
    same = lambda a: a  # noqa: E731
    if isinstance(module, nn.Linear):
        return {"kernel": ("weight", lambda a: a.T), "bias": ("bias", same)}[leaf]
    if isinstance(module, nn.Conv2d):
        return {"kernel": ("weight", lambda a: a.transpose(3, 2, 0, 1)), "bias": ("bias", same)}[leaf]
    if isinstance(module, nn.Conv3d):
        return {"kernel": ("weight", lambda a: a.transpose(4, 3, 0, 1, 2)), "bias": ("bias", same)}[leaf]
    if isinstance(module, nn.LayerNorm):
        return {"scale": ("weight", same), "bias": ("bias", same)}[leaf]
    if isinstance(module, BatchNorm2d):
        return {"scale": ("weight", same), "bias": ("bias", same), "mean": ("running_mean", same), "var": ("running_var", same)}[leaf]
    if isinstance(module, nn.Embedding):
        return {"embedding": ("weight", same)}[leaf]
    if isinstance(getattr(module, leaf, None), nn.Parameter) or (leaf in module._buffers and leaf not in module._non_persistent_buffers_set):
        return leaf, same
    raise KeyError(leaf)


@torch.no_grad()
def load_jax_params(module: nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Copy every entry of ``flat`` into ``module``'s parameters and buffers (in place, on their
    device)."""
    params = dict(module.named_parameters())
    persistent = set(module.state_dict())
    params.update((n, b) for n, b in module.named_buffers() if n in persistent)
    unused, set_names = [], set()
    for key, value in flat.items():
        *path, leaf = key.split("/")
        try:
            sub = module.get_submodule(".".join(path))
            name, convert = _target(sub, leaf)
        except (AttributeError, KeyError):
            unused.append(key)
            continue
        full = ".".join([*path, name])
        param = params[full]
        arr = np.array(convert(np.asarray(value, dtype=np.float32)), order="C")  # owned, writable
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{key}: JAX shape {arr.shape} (converted) != torch {full} {tuple(param.shape)}")
        param.copy_(torch.from_numpy(arr))
        set_names.add(full)
    missing = sorted(set(params) - set_names)
    if unused or missing:
        raise KeyError(f"load_jax_params: JAX keys left unused {sorted(unused)}; torch parameters or buffers left unset {missing}")
