"""Hand-written CUDA kernels: build and load (:mod:`.build`) and their launch counts.

Each kernel wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches its kernel and
nowhere else, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

from collections import Counter

LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
