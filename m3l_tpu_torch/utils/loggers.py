"""Metric loggers (the port's copy of ``m3l_tpu/utils/loggers.py``): TensorBoard event files
through ``torch.utils.tensorboard`` (scalars and images), an interval-gated wandb adapter, and a
logger that fans out to several.

Neither ``tensorboard`` nor ``wandb`` is imported when the module is imported. Without the
package, :class:`TensorBoardLogger` and :class:`WandbLogger` raise when they are built, naming
it (the JAX package's ``WandbLogger`` turns itself into a no-op instead).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


class TensorBoardLogger:
    """Scalars and images to event files under ``log_dir``. Needs the ``tensorboard`` package."""

    def __init__(self, log_dir: str):
        import sys
        import types

        # tensorboard's pure-python TF stub: registering `tensorboard.compat.notf` before the lazy
        # `tensorboard.compat.tf` resolves makes it skip `import tensorflow` where one is installed
        sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as exc:
            raise RuntimeError(
                "TensorBoardLogger needs the tensorboard package, which is not installed: "
                "run without --tensorboard_dir, or install tensorboard"
            ) from exc
        os.makedirs(log_dir, exist_ok=True)
        self.writer = SummaryWriter(log_dir)

    def log_scalars(self, metrics: dict, step: int) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float, np.floating, np.integer)) and np.isfinite(v):
                self.writer.add_scalar(k, float(v), global_step=step)
        self.writer.flush()

    def log_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """One (H, W, C) image, or the first of a (B, H, W, C) batch; a float image in [0, 1] is
        clipped and scaled to uint8."""
        img = image[0] if image.ndim == 4 else image
        if img.dtype != np.uint8:
            img = (np.clip(np.asarray(img, np.float32), 0.0, 1.0) * 255).astype(np.uint8)
        self.writer.add_image(tag, img, global_step=step, dataformats="HWC")
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()


class WandbLogger:
    """Scalars and videos to a wandb run, at most one scalar record per ``log_interval`` steps.
    Needs the ``wandb`` package."""

    def __init__(self, project: Optional[str] = None, entity: Optional[str] = None, run_id: Optional[str] = None,
                 config: Optional[dict] = None, log_interval: int = 1):
        try:
            import wandb
        except ImportError as exc:
            raise RuntimeError("WandbLogger needs the wandb package, which is not installed: use TensorBoardLogger, or install wandb") from exc
        self.wandb = wandb
        self.log_interval = log_interval
        self._last_step = -1
        self.run = wandb.init(project=project, entity=entity, id=run_id, config=config, resume="allow")

    def log_scalars(self, metrics: dict, step: int) -> None:
        if step - self._last_step < self.log_interval:
            return
        self._last_step = step
        self.run.log({**metrics, "global_step": step})

    def log_video(self, tag: str, path: str, step: int) -> None:
        self.run.log({tag: self.wandb.Video(path), "global_step": step})

    def close(self) -> None:
        self.run.finish()


class MultiLogger:
    """Every call goes to each of ``loggers`` (None entries dropped) that offers it."""

    def __init__(self, *loggers):
        self.loggers = [lg for lg in loggers if lg is not None]

    def log_scalars(self, metrics: dict, step: int) -> None:
        for lg in self.loggers:
            lg.log_scalars(metrics, step)

    def close(self) -> None:
        for lg in self.loggers:
            if hasattr(lg, "close"):
                lg.close()
