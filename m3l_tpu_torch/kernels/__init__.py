"""Hand-written CUDA kernels: build and load (:mod:`.build`) and their launch counts.

Each kernel wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches its kernel and
nowhere else, so a run can show that its main path went through the kernels. The attention
forward and backward each have two bodies, both on the tensor cores: bf16 (``"tensor_core"``) and
f32 in 3xTF32 (``"tf32x3"``). Each forward launch of either interface also adds one to
``FWD_BODY_LAUNCHES["tensor_core"]`` or ``FWD_BODY_LAUNCHES["tf32x3"]``, and
each backward launch to ``BWD_BODY_LAUNCHES``, so a run can show which body served it.
"""
from __future__ import annotations

from collections import Counter

LAUNCHES: Counter = Counter()
FWD_BODY_LAUNCHES: Counter = Counter()
BWD_BODY_LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
    FWD_BODY_LAUNCHES.clear()
    BWD_BODY_LAUNCHES.clear()
