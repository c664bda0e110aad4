"""Checkpoint save and load with torch state dicts (counterpart of
``m3l_tpu/train/checkpoint.py``, which writes orbax trees).

A checkpoint is one ``torch.save`` file holding a dict of state dicts, tensors and scalars. It is
written to a temporary file beside the target and renamed over it, so a reader never sees a
half-written checkpoint and a save cut short leaves the previous one whole. Loading maps every
tensor to the device the caller names: a resumed run's parameters and optimizer state stay on
the model's device (the JAX restore loses device placement; see ``ROADMAP.md``).

The SSL Trainer writes ``last.ckpt``, ``epoch-%04d.ckpt`` ({model: state dict, opt: the
optimizer's state, global_step, current_epoch}) and ``task-%04d.ckpt`` (the trainable parameters
only, with the two counts); the RL models write ``model_<steps>_steps.ckpt`` through their
callbacks. :func:`latest_checkpoint` finds either kind.
"""
from __future__ import annotations

import os
import re
from pathlib import Path

import torch

_STEPS = re.compile(r"^model_(\d+)_steps\.ckpt$")


def save_checkpoint(path: str | os.PathLike, payload: dict) -> None:
    """Write ``payload`` ({name: state dict | tensor | scalar}) to ``path``, atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def load_checkpoint(path: str | os.PathLike, map_location: str | torch.device = "cpu") -> dict:
    """Read a checkpoint written by :func:`save_checkpoint`, its tensors on ``map_location``."""
    return torch.load(Path(path), map_location=map_location, weights_only=True)


def step_checkpoints(ckpt_dir: str | os.PathLike) -> list[Path]:
    """The ``model_<steps>_steps.ckpt`` files of ``ckpt_dir`` (as ``CheckpointCallback`` names
    them), newest (most steps) first."""
    d = Path(ckpt_dir)
    found = [(int(m.group(1)), p) for p in d.glob("model_*_steps.ckpt") if (m := _STEPS.match(p.name))] if d.is_dir() else []
    return [p for _, p in sorted(found, reverse=True)]


def latest_checkpoint(ckpt_dir: str | os.PathLike) -> Path | None:
    """``last.ckpt`` in ``ckpt_dir`` if it exists, else the newest step checkpoint, else None."""
    last = Path(ckpt_dir) / "last.ckpt"
    if last.is_file():
        return last
    steps = step_checkpoints(ckpt_dir)
    return steps[0] if steps else None
