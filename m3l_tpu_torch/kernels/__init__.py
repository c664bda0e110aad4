"""Hand-written CUDA kernels: build and load (:mod:`.build`) and their launch counts.

Each kernel wrapper adds one to ``LAUNCHES[<kernel name>]`` where it launches its kernel and
nowhere else, so a run can show that its main path went through the kernels. The attention
forward and backward each have two bodies, both on the tensor cores: bf16 (``"tensor_core"``) and
f32 in 3xTF32 (``"tf32x3"``). Each forward launch of either interface also adds one to
``FWD_BODY_LAUNCHES["tensor_core"]`` or ``FWD_BODY_LAUNCHES["tf32x3"]``, and
each backward launch to ``BWD_BODY_LAUNCHES``, so a run can show which body served it. Each
launch of the packed pair that carries a key mask also adds one to ``MASKED_LAUNCHES[<kernel
name>]``. A launch recorded into a CUDA graph counts once, where the wrapper recorded it during
the capture; a replay of the graph goes through no wrapper and adds nothing, so the kernels a
replay ran are read from a device trace (:func:`device_kernels`).
"""
from __future__ import annotations

from collections import Counter

LAUNCHES: Counter = Counter()
FWD_BODY_LAUNCHES: Counter = Counter()
BWD_BODY_LAUNCHES: Counter = Counter()
MASKED_LAUNCHES: Counter = Counter()


def reset_launches() -> None:
    LAUNCHES.clear()
    FWD_BODY_LAUNCHES.clear()
    BWD_BODY_LAUNCHES.clear()
    MASKED_LAUNCHES.clear()


def device_kernels(run, name: str) -> int:
    """How many kernels whose name holds ``name`` the CUDA device ran while ``run()`` ran, read from
    a ``torch.profiler`` trace of the device alone (CUDA graph replays included)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.device_type() == DeviceType.CUDA and name in e.name() for e in prof.profiler.kineto_results.events())
