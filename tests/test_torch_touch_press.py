"""The port's TouchPress env (m3l_tpu_torch/envs/touch_press.py) and its pixels(+touch) wrappers
(m3l_tpu_torch/envs/wrappers.py) against the JAX package's.

Real MuJoCo with EGL off-screen rendering runs in a clean subprocess, as tests/test_real_mujoco.py
does (an EGL context inside the test process can crash once torch has loaded its own GL stack).
There both factories build ``MuJoCoPixels/TouchPress-v0`` at frame stack 2 and step one seeded
action sequence of 210 steps, across two truncations and their resets: the images (uint8), the
tactile maps, the rewards, the terminated and truncated flags and ``info["is_success"]`` must be
equal, with and without touch, and the raw env state and the hidden gains (k, kp) after each reset.
The wrappers' arithmetic is compared in this process on seeded inputs, exactly.
"""
import os
import subprocess
import sys

import gymnasium as gym
import numpy as np
import pytest
from gymnasium.spaces import Box as GymBox, Dict as GymDict

from m3l_tpu.envs import wrappers as jwrappers
from m3l_tpu_torch.envs import Box, Dict, make_env
from m3l_tpu_torch.envs import wrappers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 210

EQUAL_CODE = """
import os, sys
os.environ["MUJOCO_GL"] = "egl"
import numpy as np
from m3l_tpu.envs import make_env as jmake_env
from m3l_tpu_torch.envs import make_env
state_type = sys.argv[1]
envs = [f("MuJoCoPixels/TouchPress-v0", 0, 0, state_type, frame_stack=2)() for f in (jmake_env, make_env)]
inner = [e.unwrapped for e in envs]
keys = {"image"} if state_type == "vision" else {"image", "tactile"}
actions = np.random.default_rng(1).uniform(-1.0, 1.0, (%d, 1)).astype(np.float32)

def same_reset(seed):
    outs = [e.reset(seed=seed) for e in envs]
    (ja, _), (pa, _) = outs
    assert set(ja) == set(pa) == keys, (set(ja), set(pa))
    for k in keys:
        assert ja[k].dtype == pa[k].dtype and np.array_equal(ja[k], pa[k]), k
    assert np.array_equal(inner[0]._state(), inner[1]._state())
    jgains, gains = ((float(e.model.jnt_stiffness[e._plate_jnt]), float(e.model.actuator_gainprm[0, 0])) for e in inner)
    assert jgains == gains, (jgains, gains)
    return gains

gains, resets, touched, successes = [same_reset(7)], 0, 0, []
for t, a in enumerate(actions):
    (jo, jr, jterm, jtrunc, jinfo), (po, pr, pterm, ptrunc, pinfo) = (e.step(a) for e in envs)
    for k in keys:
        assert np.array_equal(jo[k], po[k]), (t, k)
    assert jr == pr and jterm == pterm and jtrunc == ptrunc, (t, jr, pr, jterm, pterm, jtrunc, ptrunc)
    assert jinfo.get("is_success") == pinfo.get("is_success"), (t, jinfo, pinfo)
    touched += "tactile" in keys and bool(np.abs(po["tactile"]).sum() > 0)
    if jterm or jtrunc:
        successes.append(pinfo["is_success"])
        gains.append(same_reset(None))
        resets += 1
assert resets == 2 and len(set(gains)) == 3, (resets, gains)
assert po["image"].shape == (2, 64, 64, 3) and po["image"].dtype == np.uint8
if "tactile" in keys:
    assert po["tactile"].shape == (2, 3, 32, 32) and touched > 0
for e in envs:
    e.close()
print("TOUCH_PRESS_EQUAL_OK", state_type, resets, successes, gains)
""" % STEPS

CLI_CODE = """
import os
os.environ["MUJOCO_GL"] = "egl"
import numpy as np
from m3l_tpu_torch.cli import train
model = train.main(["--env", "MuJoCoPixels/TouchPress-v0", "--n_envs", "2", "--rollout_length", "16", "--batch_size", "8",
                    "--ppo_epochs", "1", "--dim_embedding", "64", "--frame_stack", "2", "--mae_batch_size", "4",
                    "--compute_dtype", "float32", "--device", "cpu", "--subproc", "False", "--verbose", "0", "--total_timesteps", "32"])
m = model.last_metrics
assert model.num_timesteps == 32 and m["n_updates_executed"] == 2, (model.num_timesteps, m)
assert all(np.isfinite(v) for v in m.values()), m
print("TOUCH_PRESS_CLI_OK", sorted(m))
"""


def run(code: str, *args: str) -> str:
    pytest.importorskip("mujoco")
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code, *args], env=env, capture_output=True, text=True, timeout=300)
    return out.stdout + out.stderr


@pytest.mark.parametrize("state_type", ["vision_and_touch", "vision"])
def test_touch_press_equals_jax(state_type):
    out = run(EQUAL_CODE, state_type)
    assert f"TOUCH_PRESS_EQUAL_OK {state_type} 2" in out, out


def test_touch_press_trains_through_the_cli():
    """One iteration of ``cli.train.main`` on TouchPress (two in-process envs, one tactile sensor,
    f32 on the CPU): finite metrics."""
    out = run(CLI_CODE)
    assert "TOUCH_PRESS_CLI_OK" in out, out


def test_other_mujoco_pixels_ids_raise_naming_gymnasium():
    for name in ("MuJoCoPixels/Ant-v5", "MuJoCoPixels/HalfCheetah-v5"):
        with pytest.raises(ValueError, match="gymnasium"):
            make_env(name, 0)
        with pytest.raises(ValueError, match="gymnasium"):
            make_env(name, 0, allow_fake=True)


@pytest.mark.parametrize("n", [0, 1, 5, 16, 17, 92])
def test_assemble_hand_tactile_equals_jax(n):
    """The hand layout of n touch readings (none, one, fewer than the 16 pads, one a pad, more, the
    Shadow hand's 92), symlog-scaled, exactly as JAX's."""
    vals = np.random.default_rng(n).normal(scale=3.0, size=n).astype(np.float32)
    got, want = wrappers.assemble_hand_tactile(vals), jwrappers.assemble_hand_tactile(vals)
    assert got.shape == (3, 32, 32) and got.dtype == want.dtype and np.array_equal(got, want)
    x = np.random.default_rng(n + 1).normal(scale=10.0, size=(4, 7)).astype(np.float32)
    assert np.array_equal(wrappers.symlog(x), jwrappers.symlog(x))


class _JaxPixels(gym.Env):
    """A gymnasium env with one pixel key, for JAX's ResizeDict."""

    def __init__(self, size: int):
        self.observation_space = GymDict({"image": GymBox(0, 255, (size, size, 3), np.uint8)})
        self.action_space = GymBox(-1.0, 1.0, (1,), np.float32)


class _Pixels:
    def __init__(self, size: int):
        self.observation_space = Dict({"image": Box(0, 255, (size, size, 3), np.uint8)})
        self.action_space = Box(-1.0, 1.0, (1,), np.float32)


@pytest.mark.parametrize("size,to_float", [(96, False), (96, True), (64, False)], ids=["downsize", "to_float", "same_size"])
def test_resize_dict_equals_jax(size, to_float):
    pytest.importorskip("cv2")
    obs = {"image": np.random.default_rng(size).integers(0, 256, (size, size, 3), dtype=np.uint8), "tactile": np.ones((3, 4, 4), np.float32)}
    got = wrappers.ResizeDict(_Pixels(size), 64, to_float=to_float)
    want = jwrappers.ResizeDict(_JaxPixels(size), 64, to_float=to_float)
    a, b = got.observation(obs), want.observation(obs)
    assert a.keys() == b.keys() and a["image"].dtype == b["image"].dtype and np.array_equal(a["image"], b["image"])
    assert a["image"].shape == (64, 64, 3) and np.array_equal(a["tactile"], b["tactile"])
    space, jspace = got.observation_space["image"], want.observation_space["image"]
    assert space.shape == jspace.shape and space.dtype == jspace.dtype and np.array_equal(space.high, jspace.high)
