"""The few parts of ``gymnasium.spaces`` the port reads, so that it needs no gymnasium.

``Box`` keeps ``low``, ``high`` (arrays of ``shape`` in ``dtype``), ``shape`` and ``dtype``;
``Dict`` keeps ``spaces`` and indexes them by key.
"""
from __future__ import annotations

import numpy as np


class Box:
    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        self.shape = tuple(np.shape(low) if shape is None else shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()


class Dict:
    def __init__(self, spaces: dict):
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Box:
        return self.spaces[key]
