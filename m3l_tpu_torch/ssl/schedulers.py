"""Training schedules as plain step -> value functions (counterpart of
``m3l_tpu/ssl/schedulers.py``).

* :func:`warmup_cosine_schedule`: linear warm-up from ``start_lr`` to ``base_lr`` over
  ``warmup_steps``, then cosine to ``final_lr`` over the remaining steps.
* :func:`cosine_wd_schedule`: cosine weight decay from ``ref_wd`` to ``final_wd``.
* :func:`linear_schedule`: the EMA-momentum ramp.
* :func:`teacher_temp_schedule`: linear warm-up, then constant.

The JAX functions compute in f32 on device; these compute in Python floats (f64), which agree
to f32 rounding.
"""
from __future__ import annotations

import math


def warmup_cosine_schedule(base_lr: float, start_lr: float, final_lr: float, warmup_steps: int, total_steps: int):
    t_max = max(total_steps - warmup_steps, 1)

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return start_lr + (step / max(warmup_steps, 1)) * (base_lr - start_lr)
        progress = (step - warmup_steps) / t_max
        return max(final_lr, final_lr + (base_lr - final_lr) * 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule


def cosine_wd_schedule(ref_wd: float, final_wd: float, total_steps: int):
    def schedule(step) -> float:
        progress = float(step) / max(total_steps, 1)
        wd = final_wd + (ref_wd - final_wd) * 0.5 * (1.0 + math.cos(math.pi * progress))
        return max(final_wd, wd) if final_wd <= ref_wd else min(final_wd, wd)

    return schedule


def linear_schedule(start: float, end: float, total_steps: int):
    def schedule(step) -> float:
        frac = min(max(float(step) / max(total_steps, 1), 0.0), 1.0)
        return start + frac * (end - start)

    return schedule


def teacher_temp_schedule(temp: float | tuple[float, float], warmup_steps: int):
    if isinstance(temp, (int, float)):
        t = float(temp)
        return lambda step: t
    t0, t1 = temp

    def schedule(step) -> float:
        step = float(step)
        return t1 if step > warmup_steps else t0 + step * (t1 - t0) / max(warmup_steps, 1)

    return schedule
