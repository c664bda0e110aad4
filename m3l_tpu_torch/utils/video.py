"""Episode video annotation and encoding (a copy of ``m3l_tpu/utils/video.py``): a per-frame caption
overlay (step, reward, info key/values) and mp4 assembly. Host side; cv2 is imported where it is
used.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def annotate_frame(step: int, frame: np.ndarray, rew: float, info: Optional[dict] = None, min_size: int = 128) -> np.ndarray:
    import cv2

    if frame.dtype != np.uint8:
        f = frame
        if np.nanmax(f) <= 1.0:
            f = f * 255.0
        frame = np.clip(f, 0, 255).astype(np.uint8)
    if frame.shape[0] < min_size:
        frame = cv2.resize(frame, (int(min_size * frame.shape[1] / frame.shape[0]), min_size))
    frame = np.ascontiguousarray(frame)
    lines = [f"step: {step}", f"reward: {rew:.3f}"]
    for k, v in (info or {}).items():
        if isinstance(v, str):
            lines.append(f"{k}: {v}")
        elif isinstance(v, (int, float, bool, np.floating, np.integer)):
            lines.append(f"{k}: {v}")
    for i, text in enumerate(lines):
        cv2.putText(frame, text, (4, 12 + 12 * i), cv2.FONT_HERSHEY_SIMPLEX, 0.35, (255, 255, 255), 1, cv2.LINE_AA)
    return frame


def write_video(frames: Sequence[np.ndarray], path: str, fps: int = 20) -> str:
    import cv2

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        if f.dtype != np.uint8:
            f = np.clip(f * 255.0 if np.nanmax(f) <= 1.0 else f, 0, 255).astype(np.uint8)
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return path
