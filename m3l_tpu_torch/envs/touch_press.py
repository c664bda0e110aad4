"""TouchPress-v0, the force-regulation env where touch is load-bearing (the port's own copy of
``m3l_tpu/envs/touch_press.py`` ``TouchPressEnv``, on the port's spaces instead of gymnasium's).

A position-actuated fingertip presses a spring-mounted plate toward a target contact force. Each
episode draws two gains the camera cannot see: the plate stiffness k ~ U(80, 1200) N/m and the
servo gain kp ~ U(30, 160) N/m, so every pixel-observable quantity maps to a different force each
episode and regulating the force needs the fingertip's MuJoCo touch sensor. The action moves the
servo setpoint by up to DCTRL_MAX a step (the setpoint integrates env-side); the reward is
-min(|F - F_target| / F_target, 1); an episode is HORIZON steps, truncated there (as gymnasium's
``TimeLimit`` would), and its ``info["is_success"]`` says whether 60 % of its second half stayed
within 25 % of the target. The same seed and actions give the same states, rewards, flags and
frames as the JAX package's env. ``mujoco`` is imported when an env is built, not with the module.

``make_env("MuJoCoPixels/TouchPress-v0", ...)`` renders it (``RenderImageObservation``) and maps the
touch sensor into the (3, 32, 32) tactile image (``assemble_hand_tactile``).
"""
from __future__ import annotations

import numpy as np

from .spaces import Box

_XML = """
<mujoco model="touchpress">
  <option timestep="0.005" gravity="0 0 -9.81"/>
  <visual>
    <global offwidth="128" offheight="128"/>
    <quality shadowsize="0" offsamples="0"/>
    <headlight ambient="0.4 0.4 0.4" diffuse="0.6 0.6 0.6"/>
  </visual>
  <worldbody>
    <light pos="0.2 0.2 1" dir="-0.2 -0.2 -1" castshadow="false"/>
    <geom name="floor" type="plane" size="1 1 0.1" rgba="0.25 0.27 0.32 1"/>
    <body name="base" pos="0 0 0.035">
      <geom name="pedestal" type="cylinder" size="0.05 0.035" rgba="0.4 0.4 0.45 1"/>
    </body>
    <body name="plate" pos="0 0 0.22">
      <joint name="plate_z" type="slide" axis="0 0 1" range="-0.12 0"
             stiffness="300" damping="8" limited="true"/>
      <geom name="plate_geom" type="box" size="0.07 0.07 0.02" mass="0.15"
            solref="0.02 1" rgba="0.85 0.55 0.2 1"/>
    </body>
    <body name="finger" pos="0 0 0.3">
      <joint name="finger_z" type="slide" axis="0 0 1" range="-0.28 0.04"
             damping="6" limited="true"/>
      <geom name="shaft" type="capsule" fromto="0 0 0.01 0 0 0.1" size="0.008"
            rgba="0.6 0.62 0.68 1" mass="0.04"/>
      <geom name="tip" type="sphere" size="0.014" rgba="0.2 0.6 0.9 1" mass="0.02"/>
      <site name="tip_site" type="sphere" size="0.016" rgba="1 0 0 0"/>
    </body>
    <camera name="view" pos="0.38 0 0.34" xyaxes="0 1 0 -0.2 0 1"/>
  </worldbody>
  <actuator>
    <position name="press" joint="finger_z" kp="60" ctrlrange="-0.28 0.04"/>
  </actuator>
  <sensor>
    <touch name="tip_touch" site="tip_site"/>
  </sensor>
</mujoco>
"""


class TouchPressEnv:
    """Regulate the fingertip's contact force on a plate of hidden stiffness under a servo of
    hidden gain. The raw observation is (finger height, plate height, plate velocity, force); the
    pixels(+touch) pipeline replaces it with ``render()`` and the touch map."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 40}

    F_TARGET = 4.0
    HORIZON = 100
    DCTRL_MAX = 0.01  # metres of setpoint travel per env step

    def __init__(self, render_mode: str = "rgb_array", width: int = 64, height: int = 64):
        import mujoco

        self._mujoco = mujoco
        self.model = mujoco.MjModel.from_xml_string(_XML)
        self.data = mujoco.MjData(self.model)
        self.render_mode = render_mode
        self._renderer = None
        self._width, self._height = width, height
        self._plate_jnt = mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_JOINT, "plate_z")
        self._touch_adr = self.model.sensor_adr[mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_SENSOR, "tip_touch")]
        self._ctrl_lo, self._ctrl_hi = self.model.actuator_ctrlrange[0]
        self.action_space = Box(low=-1.0, high=1.0, shape=(1,), dtype=np.float32)
        self.observation_space = Box(low=-np.inf, high=np.inf, shape=(4,), dtype=np.float32)
        self._rng = np.random.default_rng(0)
        self._t = 0
        self._in_band = 0

    @property
    def unwrapped(self):
        return self

    def _force(self) -> float:
        return float(self.data.sensordata[self._touch_adr])

    def _state(self) -> np.ndarray:
        return np.array([self.data.qpos[0], self.data.qpos[1], self.data.qvel[1], self._force()], np.float32)

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        mujoco, model, data = self._mujoco, self.model, self.data
        mujoco.mj_resetData(model, data)
        # the stiffness; the spring reference absorbs the gravity sag, so the plate rests at the
        # same height for every k (else the sag shows k to the camera), and the damping stays
        # near-critical at every k
        plate_mass = 0.15
        k = self._rng.uniform(80.0, 1200.0)
        model.jnt_stiffness[self._plate_jnt] = k
        model.dof_damping[model.jnt_dofadr[self._plate_jnt]] = 1.8 * np.sqrt(plate_mass * k)
        model.qpos_spring[model.jnt_qposadr[self._plate_jnt]] = plate_mass * 9.81 / k
        # the servo gain (a position actuator: gainprm[0] = kp, biasprm = (0, -kp, -kv)); with kp
        # fixed, vision could read the force off the servo's visible position error
        kp = self._rng.uniform(30.0, 160.0)
        model.actuator_gainprm[0, 0] = kp
        model.actuator_biasprm[0, 1] = -kp
        # every episode starts in contact at a force F0 ~ U(0.5, 7) N: the setpoint past the contact
        # point by F0 / kp (the finger's weight folded in), then 0.2 s to settle
        contact_q = -0.046
        f0 = self._rng.uniform(0.5, 7.0)
        data.qpos[1] = contact_q
        data.ctrl[0] = contact_q - (f0 - 0.06 * 9.81) / kp
        mujoco.mj_forward(model, data)
        for _ in range(40):
            mujoco.mj_step(model, data)
        self._t = 0
        self._in_band = 0
        return self._state(), {}

    def step(self, action):
        a = float(np.clip(np.asarray(action).ravel()[0], -1.0, 1.0))
        self.data.ctrl[0] = np.clip(self.data.ctrl[0] + a * self.DCTRL_MAX, self._ctrl_lo, self._ctrl_hi)
        for _ in range(4):  # 50 Hz control over 5 ms physics steps
            self._mujoco.mj_step(self.model, self.data)
        self._t += 1
        f = self._force()
        err = abs(f - self.F_TARGET) / self.F_TARGET
        reward = -min(err, 1.0)
        if self._t > self.HORIZON // 2 and err < 0.25:
            self._in_band += 1
        truncated = self._t >= self.HORIZON
        info = {}
        if truncated:
            info["is_success"] = self._in_band >= 0.6 * (self.HORIZON // 2)
        return self._state(), reward, False, truncated, info

    def render(self):
        if self._renderer is None:
            self._renderer = self._mujoco.Renderer(self.model, height=self._height, width=self._width)
        self._renderer.update_scene(self.data, camera="view")
        return self._renderer.render()

    def close(self) -> None:
        if self._renderer is not None:
            self._renderer.close()
            self._renderer = None
