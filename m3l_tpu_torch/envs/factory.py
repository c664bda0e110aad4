"""Environment factory (the port's own copy of ``m3l_tpu/envs/factory.py`` ``make_env``).

Only the fake family is ported: ``Fake*`` names build :class:`FakeInsertionEnv` (two tactile
sensors, seeded ``seed + rank``) under ``FrameStack``. The tactile_envs, robosuite, Shadow-hand
and MuJoCo-pixels families are a later slice, and ``make_env`` raises for them rather than
substituting a fake. Envs are host numpy: they take no device.
"""
from __future__ import annotations

from .fake import FakeInsertionEnv
from .wrappers import FrameStack


def make_env(
    env_name: str,
    rank: int,
    seed: int = 0,
    state_type: str = "vision_and_touch",
    frame_stack: int = 1,
    image_size: int = 64,
    tactile_size: int = 32,
):
    """A thunk that builds env ``rank`` of a pool (for :class:`SyncVecEnv`)."""
    if not env_name.startswith("Fake"):
        raise ValueError(f"make_env: env family of {env_name!r} is not ported yet; only Fake* envs are")

    def _init():
        env = FakeInsertionEnv(state_type=state_type, num_sensors=2, seed=seed + rank, image_size=image_size, tactile_size=tactile_size)
        return FrameStack(env, frame_stack)

    return _init
