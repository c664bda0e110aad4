"""Metric logging to TensorBoard event files (the port's copy of ``m3l_tpu/utils/loggers.py``
``TensorBoardLogger``, scalars only), through ``torch.utils.tensorboard``."""
from __future__ import annotations

import os

import numpy as np


class TensorBoardLogger:
    """Scalars to event files under ``log_dir``. Needs the ``tensorboard`` package,
    imported here and not when the module is imported; without it the constructor raises."""

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

    def close(self) -> None:
        self.writer.close()
