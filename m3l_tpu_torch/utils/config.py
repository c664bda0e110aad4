"""Hydra-style config system (counterpart of ``m3l_tpu/utils/config.py``): a YAML tree with
``_target_`` instantiation.

* ``_target_: pkg.module.Class`` instantiates (``_partial_: true`` returns a functools.partial).
  A target under ``m3l_tpu.`` resolves to the same path under ``m3l_tpu_torch.``, so the
  repository's ``config/`` tree builds the port's modules; ``m3l_tpu`` is never imported.
* A ``defaults:`` list composes group files (``model: mae_vit`` loads ``model/mae_vit.yaml`` into
  ``model``; later entries and the file's own body override earlier ones).
* ``${a.b.c}`` interpolation, with ``${key:default}`` fallbacks.
* Dotted command-line overrides (``model.encoder.embed_dim=384``).

Files, override values and ``${key:default}`` defaults are read with PyYAML's ``safe_load``, as
in the JAX package.
"""
from __future__ import annotations

import functools
import importlib
import os
import re
from typing import Any, Optional

import yaml

_INTERP = re.compile(r"\$\{([^}]+)\}")


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _lookup(cfg: dict, dotted: str, default=...) -> Any:
    cur: Any = cfg
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        else:
            if default is ...:
                raise KeyError(dotted)
            return default
    return cur


def _interpolate(node: Any, root: dict, _depth: int = 0) -> Any:
    """Recursive ``${...}`` resolution (looked-up values may interpolate again), depth-capped
    against cycles."""
    if _depth > 16:
        raise RecursionError("interpolation cycle detected")

    def resolve(expr: str):
        if ":" in expr:
            key, default = expr.split(":", 1)
            val = _lookup(root, key.strip(), yaml.safe_load(default))
        else:
            val = _lookup(root, expr.strip())
        return _interpolate(val, root, _depth + 1)

    if isinstance(node, str):
        full = _INTERP.fullmatch(node.strip())
        if full:
            return resolve(full.group(1))
        return _INTERP.sub(lambda m: str(resolve(m.group(1))), node)
    if isinstance(node, dict):
        return {k: _interpolate(v, root, _depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root, _depth) for v in node]
    return node


def load_config(path: str, overrides: Optional[list[str]] = None, _top: bool = True) -> dict:
    """Load a YAML config, composing its ``defaults:`` list relative to the config root, then
    apply dotted overrides and, at the top-level call only, interpolation (so an override of an
    interpolated key such as ``model_size=base`` reaches the groups)."""
    path = os.path.abspath(path)
    root_dir = os.path.dirname(path)
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    defaults = cfg.pop("defaults", [])

    def _resolve(rel: str) -> str:
        # against this file's directory, then each ancestor up to the config root
        base = root_dir
        seen = set()
        while base and base not in seen:
            seen.add(base)
            cand = os.path.join(base, rel)
            if os.path.isfile(cand):
                return cand
            base = os.path.dirname(base)
        raise FileNotFoundError(f"config group file {rel!r} (from {path})")

    composed: dict = {}
    for entry in defaults:
        if entry == "_self_":
            composed = _deep_merge(composed, cfg)
            cfg = {}
            continue
        if isinstance(entry, dict):
            ((group, name),) = entry.items()
            if name is None:
                continue
            # a group selection replaces the group's content (Hydra semantics)
            composed = dict(composed)
            composed[group] = load_config(_resolve(os.path.join(group, f"{name}.yaml")), _top=False)
        else:
            composed = _deep_merge(composed, load_config(_resolve(f"{entry}.yaml"), _top=False))
    composed = _deep_merge(composed, cfg)
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        node = composed
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(raw)
    if not _top:
        return composed
    return _interpolate(composed, composed)


def target_path(target: str) -> str:
    """The port's module path for a ``_target_``: ``m3l_tpu.x`` becomes ``m3l_tpu_torch.x``."""
    return "m3l_tpu_torch." + target.removeprefix("m3l_tpu.") if target.startswith("m3l_tpu.") else target


def _import_target(target: str):
    module, _, attr = target_path(target).rpartition(".")
    return getattr(importlib.import_module(module), attr)


def instantiate(cfg: Any, **kwargs) -> Any:
    """Recursively instantiate ``_target_`` nodes (Hydra semantics); ``kwargs`` go to the
    top-level target."""
    if isinstance(cfg, list):
        return [instantiate(v) for v in cfg]
    if not isinstance(cfg, dict):
        return cfg
    if "_target_" not in cfg:
        return {k: instantiate(v) for k, v in cfg.items()}
    cfg = dict(cfg)
    target = _import_target(cfg.pop("_target_"))
    partial = bool(cfg.pop("_partial_", False))
    args = {k: instantiate(v) for k, v in cfg.items()}
    args.update(kwargs)
    if partial:
        return functools.partial(target, **args)
    return target(**args)


def print_config(cfg: dict, indent: int = 0) -> str:
    """The config tree as indented text; prints it and returns it."""
    lines = []

    def walk(node, depth):
        pad = "  " * depth
        if isinstance(node, dict):
            for k, v in node.items():
                if isinstance(v, (dict, list)) and v:
                    lines.append(f"{pad}{k}:")
                    walk(v, depth + 1)
                else:
                    lines.append(f"{pad}{k}: {v}")
        elif isinstance(node, list):
            for v in node:
                lines.append(f"{pad}- {v}")

    walk(cfg, indent)
    out = "\n".join(lines)
    print(out)
    return out
