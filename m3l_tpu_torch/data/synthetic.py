"""Synthetic DIGIT-style tactile data with ground-truth force and slip labels (a numpy copy of
``m3l_tpu/data/synthetic.py``; the same seed gives the same arrays, bit for bit).

A gel-illumination renderer whose labels are recoverable from pixels:

* normal force ``fz``   -> indentation blob radius and darkening depth;
* shear force ``fx,fy`` -> per-channel brightness change inside the contact patch under three
  DIGIT-like light directions (120 degrees apart);
* slip                  -> contact-patch velocity above a threshold.

Trajectories are smooth (OU dynamics), so 2-frame windows carry motion cues.
"""
from __future__ import annotations

import numpy as np

# DIGIT-like tri-directional illumination (unit vectors, 120 degrees apart)
_LIGHT_DIRS = np.array([[1.0, 0.0], [-0.5, np.sqrt(3) / 2], [-0.5, -np.sqrt(3) / 2]], np.float32)


def _smooth_noise(rng, h, w, cells=6, amp=1.0):
    """Low-frequency value noise via bilinear upsampling of a coarse grid."""
    g = rng.normal(size=(cells + 1, cells + 1)).astype(np.float32)
    ys = np.linspace(0, cells, h, endpoint=False)
    xs = np.linspace(0, cells, w, endpoint=False)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    v = (
        g[y0][:, x0] * (1 - fy) * (1 - fx)
        + g[y0 + 1][:, x0] * fy * (1 - fx)
        + g[y0][:, x0 + 1] * (1 - fy) * fx
        + g[y0 + 1][:, x0 + 1] * fy * fx
    )
    return amp * v


def render_frame(bg: np.ndarray, pos: np.ndarray, force: np.ndarray, size: int) -> np.ndarray:
    """One (H, W, 3) float frame in [0,1]. bg: (H,W,3) float."""
    h = w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / size  # [0,1)
    fx, fy, fz = float(force[0]), float(force[1]), float(force[2])
    img = bg.copy()
    if fz > 1e-3:
        r = 0.08 + 0.10 * fz  # blob radius grows with normal force
        d2 = (yy - pos[1]) ** 2 + (xx - pos[0]) ** 2
        blob = np.exp(-d2 / (2 * r * r))  # (H, W)
        # indentation darkening with depth ~ fz
        img -= (0.40 * fz) * blob[..., None]
        # shear: per-channel brightening along each light direction
        shade = _LIGHT_DIRS @ np.array([fx, fy], np.float32)  # (3,)
        img += 0.35 * blob[..., None] * shade[None, None, :]
        # ring highlight at the contact edge (gel membrane bulge)
        ring = np.exp(-((np.sqrt(d2) - r) ** 2) / (2 * (0.25 * r) ** 2))
        img += 0.15 * fz * ring[..., None]
    return np.clip(img, 0.0, 1.0)


def synth_digit_trajectories(
    n_traj: int,
    traj_len: int,
    *,
    size: int = 96,
    slip_threshold: float = 0.012,
    textures: int | None = None,
    seed: int = 0,
):
    """Returns dict of aligned arrays over n_traj*traj_len frames:
    frames (N,H,W,3) uint8, force (N,3) f32 in [-1,1]^2 x [0,1],
    slip (N,) int64, traj_id (N,), in_contact (N,) f32.

    ``textures=K`` additionally assigns each trajectory a texture class
    k in [0, K) and weaves a class-keyed oriented micro-grating into the gel
    background (the T6-textile analogue for this synthetic rig, reference
    downstream_task/textile_sl.py classification). The class signature is the
    grating ORIENTATION (+ mild frequency offset) — a global, translation-
    invariant second-order statistic with per-trajectory random phase, sign,
    and jitter, so it is not readable from mean intensity. Returns an extra
    ``textile`` (N,) int64 array."""
    rng = np.random.default_rng(seed)
    N = n_traj * traj_len
    frames = np.zeros((N, size, size, 3), np.uint8)
    forces = np.zeros((N, 3), np.float32)
    slips = np.zeros(N, np.int64)
    contact = np.zeros(N, np.float32)
    traj_id = np.repeat(np.arange(n_traj), traj_len)
    textile = np.zeros(N, np.int64)
    positions = np.zeros((N, 2), np.float32)

    for ti in range(n_traj):
        # per-trajectory background: channel gradients + low-freq speckle
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        bg = np.stack(
            [0.45 + 0.15 * (_LIGHT_DIRS[c, 0] * xx + _LIGHT_DIRS[c, 1] * yy) for c in range(3)], axis=-1
        )
        bg += _smooth_noise(rng, size, size, cells=8, amp=0.05)[..., None]
        bg += rng.normal(size=(size, size, 3)).astype(np.float32) * 0.005
        if ti == 0:
            bg_frames = np.zeros((n_traj, size, size, 3), np.uint8)
        if textures:
            k = int(rng.integers(textures))
            textile[ti * traj_len : (ti + 1) * traj_len] = k
            theta = k * np.pi / textures + rng.normal() * 0.04  # class = orientation
            freq = 7.0 + 2.0 * (k % 3) + rng.normal() * 0.3  # + mild frequency key
            phase = rng.uniform(0, 2 * np.pi)
            grating = np.sin(2 * np.pi * freq * (np.cos(theta) * xx + np.sin(theta) * yy) + phase)
            bg += (0.06 * rng.choice([-1.0, 1.0])) * grating[..., None]

        bg_frames[ti] = (np.clip(bg, 0.0, 1.0) * 255).astype(np.uint8)
        pos = rng.uniform(0.3, 0.7, size=2).astype(np.float32)
        vel = np.zeros(2, np.float32)
        f = np.array([0.0, 0.0, 0.0], np.float32)
        fz_target = rng.uniform(0.3, 1.0)
        shear_target = np.zeros(2, np.float32)
        phase = "off"  # off -> stick -> slip -> ... (bimodal slip signal)
        t_switch = 0
        for t in range(traj_len):
            i = ti * traj_len + t
            if t >= t_switch:
                if phase == "off":
                    phase = "stick"
                    fz_target = rng.uniform(0.3, 1.0)
                    shear_target = rng.uniform(-0.8, 0.8, size=2).astype(np.float32)
                    vel = np.zeros(2, np.float32)
                elif phase == "stick" and rng.uniform() < 0.7:
                    phase = "slip"  # breakaway: the patch starts moving
                    ang = rng.uniform(0, 2 * np.pi)
                    speed = rng.uniform(2.0, 4.5) * slip_threshold
                    vel = np.array([np.cos(ang), np.sin(ang)], np.float32) * speed
                else:
                    phase = "off" if rng.uniform() < 0.5 else "stick"
                    vel = np.zeros(2, np.float32)
                t_switch = t + int(rng.integers(6, 18))
            if phase != "off":
                f[2] += 0.25 * (fz_target - f[2]) + rng.normal() * 0.02
                f[2] = np.clip(f[2], 0.05, 1.0)
                if phase == "slip":
                    # kinetic friction: shear aligns with motion direction
                    v = vel / (np.linalg.norm(vel) + 1e-8)
                    f[:2] = np.clip(0.7 * f[:2] + 0.3 * v * (0.5 + 0.5 * f[2]) + rng.normal(size=2) * 0.03, -1, 1)
                    pos = np.clip(pos + vel, 0.15, 0.85)
                else:
                    # static shear load, no motion beyond jitter
                    f[:2] = np.clip(0.8 * f[:2] + 0.2 * shear_target + rng.normal(size=2) * 0.03, -1, 1)
                    pos = np.clip(pos + rng.normal(size=2).astype(np.float32) * 0.001, 0.15, 0.85)
                slips[i] = int(phase == "slip")
                contact[i] = 1.0
            else:
                f *= 0.5
                if rng.uniform() < 0.1:
                    pos = rng.uniform(0.3, 0.7, size=2).astype(np.float32)
            frames[i] = (render_frame(bg, pos, f if phase != "off" else np.zeros(3), size) * 255).astype(np.uint8)
            forces[i] = f if phase != "off" else 0.0
            positions[i] = pos
    out = {
        "frames": frames,
        "force": forces,
        "slip": slips,
        "traj_id": traj_id,
        "in_contact": contact,
        "pos": positions,
        "bg_frames": bg_frames,
    }
    if textures:
        out["textile"] = textile
    return out


def windowed_probe_samples(data: dict, num_frames: int = 2, stride: int = 1, pose_bins: int = 10):
    """Channel-concatenated ``num_frames``-windows (the reference's
    concat_ch_img out_format, vision_tactile.py:160-166) with the LAST
    frame's labels; windows never straddle trajectory boundaries.

    Returns {image (M,H,W,3*num_frames) uint8, force (M,3), slip (M,)} plus,
    when the generator recorded contact positions:

    * T3 pose labels (reference pose_sl.py:170-196 bins pose into class
      heads): ``pose_x``/``pose_y`` = contact-blob position binned over its
      [0.15, 0.85] range, ``pose_theta`` = shear direction atan2(fy, fx)
      binned over [-pi, pi) — all pixel-recoverable in contact (blob
      location; tri-light channel shading).
    * T4 grasp-stability label (grasp_sl.py:66-178 binary): gripping =
      firm contact (fz >= 0.45) that is NOT slipping — recoverable from
      blob size/darkening + 2-frame motion."""
    frames, tid = data["frames"], data["traj_id"]
    span = (num_frames - 1) * stride
    idx = np.arange(span, len(frames))
    ok = tid[idx] == tid[idx - span]
    idx = idx[ok]
    windows = np.concatenate([frames[idx - span + j * stride] for j in range(num_frames)], axis=-1)
    out = {
        "image": windows,
        "force": data["force"][idx],
        "slip": data["slip"][idx],
        "in_contact": data["in_contact"][idx],
    }
    if "textile" in data:
        out["textile"] = data["textile"][idx]
    if "pos" in data:
        pos = data["pos"][idx]
        f = data["force"][idx]
        scaled = np.clip((pos - 0.15) / 0.7, 0.0, 1.0 - 1e-6)
        out["pose_x"] = (scaled[:, 0] * pose_bins).astype(np.int64)
        out["pose_y"] = (scaled[:, 1] * pose_bins).astype(np.int64)
        theta = np.arctan2(f[:, 1], f[:, 0])  # [-pi, pi]
        out["pose_theta"] = np.minimum(
            ((theta + np.pi) / (2 * np.pi) * pose_bins).astype(np.int64), pose_bins - 1
        )
        out["grasp"] = ((f[:, 2] >= 0.45) & (data["slip"][idx] == 0)).astype(np.int64)
    return out


def forcefield_windows(data: dict, mask_threshold: float = 0.05):
    """ForceFieldSSL-format samples (reference
    vision_tactile_forcefield.py:93-138 concat_ch_img + add_bg):

    * ``image``    (M, H, W, 6) uint8 = [frame_0, frame_{-1}] — the shear
      branch warps frame_{-1} -> frame_0 by the predicted flow;
    * ``image_bg`` (M, H, W, 6) uint8 = [frame_0, background] — the normal
      branch reads disparity from the contact indentation against the clean
      gel background (`_get_tactile_images(add_bg=True)`);
    * ``mask``     (M, H, W) f32 contact mask (|frame_0 - bg| above
      threshold) for the optional mask supervision;
    * ``force``    (M, 3) ground-truth integrated force for evaluation /
      optional SL supervision.

    Windows never straddle trajectory boundaries."""
    frames, tid, bgs = data["frames"], data["traj_id"], data["bg_frames"]
    idx = np.arange(1, len(frames))
    idx = idx[tid[idx] == tid[idx - 1]]
    frame0 = frames[idx]
    frame_m1 = frames[idx - 1]
    bg = bgs[tid[idx]]
    diff = np.abs(frame0.astype(np.float32) - bg.astype(np.float32)).mean(-1) / 255.0
    return {
        "image": np.concatenate([frame0, frame_m1], axis=-1),
        "image_bg": np.concatenate([frame0, bg], axis=-1),
        "mask": (diff > mask_threshold).astype(np.float32),
        "force": data["force"][idx],
        "in_contact": data["in_contact"][idx],
    }
