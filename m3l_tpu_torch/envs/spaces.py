"""The few parts of ``gymnasium.spaces`` the port reads, so that it needs no gymnasium.

``Box`` keeps ``low``, ``high`` (arrays of ``shape`` in ``dtype``), ``shape`` and ``dtype``, and
samples a bounded box uniformly from a caller's numpy ``Generator``; ``Dict`` keeps ``spaces``
and indexes them by key.
"""
from __future__ import annotations

import numpy as np


class Box:
    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        self.shape = tuple(np.shape(low) if shape is None else shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        """A point drawn uniformly from [low, high] with ``rng`` (gymnasium's rule for a bounded
        box; its draws come from the space's own generator, so the two never match bit for bit)."""
        if not (np.isfinite(self.low).all() and np.isfinite(self.high).all()):
            raise ValueError("Box.sample: only a bounded box can be sampled")
        return rng.uniform(self.low, self.high, self.shape).astype(self.dtype)


class Dict:
    def __init__(self, spaces: dict):
        self.spaces = dict(spaces)

    def __getitem__(self, key: str) -> Box:
        return self.spaces[key]
