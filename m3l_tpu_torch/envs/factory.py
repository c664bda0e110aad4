"""Environment factory (the port's own copy of ``m3l_tpu/envs/factory.py`` ``make_env``).

Two families are ported. ``Fake*`` names build :class:`FakeInsertionEnv` (two tactile sensors,
seeded ``seed + rank``); ``MuJoCoPixels/TouchPress-v0`` builds :class:`.touch_press.TouchPressEnv`
(real MuJoCo, rendered off-screen with ``MUJOCO_GL=egl`` unless it is set) behind
``RenderImageObservation``, its touch map the one tactile sensor unless ``state_type`` is
"vision", as the JAX factory's ``gym.make`` branch builds it. Both under ``FrameStack``. The other
``MuJoCoPixels/`` ids are gymnasium's MuJoCo envs, and the tactile_envs, robosuite and Shadow-hand
families need their packages: ``make_env`` raises for them, unless ``allow_fake`` lets the fake
stand in for the tactile_envs and robosuite families, loudly, as the JAX factory does when a
family's package is missing. Envs are host numpy: they take no device.
"""
from __future__ import annotations

import os
import sys
from functools import partial

from .fake import FakeInsertionEnv
from .wrappers import FrameStack, RenderImageObservation

TOUCH_PRESS = "MuJoCoPixels/TouchPress-v0"


def _build(env_name: str, rank: int, seed: int, state_type: str, frame_stack: int, image_size: int, tactile_size: int):
    if env_name == TOUCH_PRESS:
        os.environ.setdefault("MUJOCO_GL", "egl")
        from .touch_press import TouchPressEnv

        env = TouchPressEnv(render_mode="rgb_array", width=image_size, height=image_size)
        env = RenderImageObservation(env, size=image_size, tactile_size=tactile_size, with_tactile=state_type != "vision")
        return FrameStack(env, frame_stack)
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
    if env_name.startswith("MuJoCoPixels/") and env_name != TOUCH_PRESS:
        raise ValueError(f"make_env: {env_name!r} is a gymnasium MuJoCo env, which the port does not build (it needs gymnasium); "
                         f"of the MuJoCoPixels/ family only {TOUCH_PRESS} is ported")
    fake_may_stand_in = allow_fake and not env_name.startswith(("HandManipulate", "MuJoCoPixels/"))
    if not env_name.startswith("Fake") and env_name != TOUCH_PRESS and not fake_may_stand_in:
        raise ValueError(f"make_env: env family of {env_name!r} is not ported yet; only Fake* envs and {TOUCH_PRESS} are")
    return partial(_build, env_name, rank, seed, state_type, frame_stack, image_size, tactile_size)
