"""Per-task datasets of the downstream probes (the port's own numpy copy of
``m3l_tpu/data/task_datasets.py``).

One factory covers every (sensor, task) pair: a :class:`VisionTactileDataset` window over the
sensor frames joined with the task's label arrays, aligned to the last frame of each window, with
the per-task conventions: force divided by its largest |f| per axis (plus 1e-8), the scale riding
along as ``force_scale``; slip, grasp and textile as integer classes; pose x / y / theta binned
over the buffer's own range.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .datasets import VisionTactileDataset, load_pickle_dataset

LABEL_KEYS = {
    "force": ("force",),
    "slip": ("slip",),
    "pose": ("pose_x", "pose_y", "pose_theta"),
    "grasp": ("grasp",),
    "textile": ("textile",),
}


def bin_labels(values: np.ndarray, num_bins: int, lo: Optional[float] = None, hi: Optional[float] = None) -> np.ndarray:
    """Continuous values -> class bins over [lo, hi] (the values' own range by default)."""
    lo = float(values.min()) if lo is None else lo
    hi = float(values.max()) if hi is None else hi
    scaled = (values - lo) / max(hi - lo, 1e-8)
    return np.clip((scaled * num_bins).astype(np.int64), 0, num_bins - 1)


def make_task_dataset(
    path_or_buffer,
    task: str,
    *,
    num_frames: int = 2,
    frame_stride: int = 1,
    out_format: str = "concat_ch_img",
    remove_background: bool = False,
    pose_bins: int = 10,
    force_scale: Optional[np.ndarray] = None,
) -> VisionTactileDataset:
    """The dataset of ``task`` from a pickled buffer's path or a dict {frames (or image), labels}."""
    buf = load_pickle_dataset(path_or_buffer) if isinstance(path_or_buffer, str) else dict(path_or_buffer)
    frames = np.asarray(buf.pop("frames") if "frames" in buf else buf.pop("image"))
    labels: dict = {}
    if task == "force":
        f = np.asarray(buf["force"], np.float32)
        scale = np.asarray(force_scale, np.float32) if force_scale is not None else np.abs(f).max(axis=0, keepdims=True) + 1e-8
        labels["force"] = (f / scale).astype(np.float32)
        labels["force_scale"] = np.broadcast_to(scale, f.shape).astype(np.float32)
    elif task == "slip":
        labels["slip"] = np.asarray(buf["slip"]).astype(np.int64).reshape(-1)
        if "force" in buf:
            labels["force"] = np.asarray(buf["force"], np.float32)
    elif task == "pose":
        pose = np.asarray(buf["pose"], np.float32)  # (T, 3): x, y, theta
        for i, key in enumerate(LABEL_KEYS["pose"]):
            labels[key] = bin_labels(pose[:, i], pose_bins)
    elif task in ("grasp", "textile"):
        labels[task] = np.asarray(buf[task]).astype(np.int64).reshape(-1)
    else:
        raise ValueError(f"unknown task {task!r}")
    return VisionTactileDataset(
        frames,
        num_frames=num_frames,
        frame_stride=frame_stride,
        out_format=out_format,
        remove_background=remove_background,
        labels=labels,
    )
