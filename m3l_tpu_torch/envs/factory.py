"""Environment factory (the port's own copy of ``m3l_tpu/envs/factory.py`` ``make_env``).

Only the fake family is ported: ``Fake*`` names build :class:`FakeInsertionEnv` (two tactile
sensors, seeded ``seed + rank``) under ``FrameStack``. The tactile_envs, robosuite, Shadow-hand
and MuJoCo-pixels families are a later slice: ``make_env`` raises for them, unless
``allow_fake`` lets the fake stand in for the tactile_envs and robosuite families, loudly, as the
JAX factory does when a family's package is missing. Envs are host numpy: they take no device.
"""
from __future__ import annotations

import sys
from functools import partial

from .fake import FakeInsertionEnv
from .wrappers import FrameStack


def _build(env_name: str, rank: int, seed: int, state_type: str, frame_stack: int, image_size: int, tactile_size: int):
    if not env_name.startswith("Fake"):
        print(f"WARNING: env '{env_name}' is not ported; substituting FakeInsertionEnv (allow_fake=True)", file=sys.stderr, flush=True)
    env = FakeInsertionEnv(state_type=state_type, num_sensors=2, seed=seed + rank, image_size=image_size, tactile_size=tactile_size)
    return FrameStack(env, frame_stack)


def make_env(
    env_name: str,
    rank: int,
    seed: int = 0,
    state_type: str = "vision_and_touch",
    frame_stack: int = 1,
    image_size: int = 64,
    tactile_size: int = 32,
    allow_fake: bool = False,
):
    """A thunk that builds env ``rank`` of a pool. It pickles (a ``functools.partial`` of a
    module function), so process pools started with ``spawn`` can send it to their workers."""
    fake_may_stand_in = allow_fake and not env_name.startswith(("HandManipulate", "MuJoCoPixels/"))
    if not env_name.startswith("Fake") and not fake_may_stand_in:
        raise ValueError(f"make_env: env family of {env_name!r} is not ported yet; only Fake* envs are")
    return partial(_build, env_name, rank, seed, state_type, frame_stack, image_size, tactile_size)
