"""Offline datasets and the input pipeline (the port's own numpy copy of
``m3l_tpu/data/datasets.py``).

Pickled sensor buffers with background removal, and the frame-window dataset: a sliding window
of ``num_frames`` frames ``frame_stride`` apart, emitted as ``concat_ch_img`` (channels
concatenated) or ``single_image`` in f32 over [0, 1], or ``video`` (T-major stack) as the uint8 clip
itself, which the consumers' ``as_float_image`` scales on the device. An epoch-shuffled batching
DataLoader over in-memory numpy arrays; the Trainer moves batches to the device. Augmentations
(flip, crop-resize) are numpy transforms.
"""
from __future__ import annotations

import pickle
from typing import Callable, Iterator, Optional

import numpy as np

from ..utils import trace


def load_pickle_dataset(path: str) -> dict:
    """Load a pickled sensor buffer {key: np.ndarray}."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return {k: np.asarray(v) for k, v in data.items()}


def background_difference(frames: np.ndarray, bg: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-frame background removal (reference digit/utils.py:51-58): signed
    difference to a background frame (default: the first frame), shifted back
    to the image range."""
    bg = frames[0] if bg is None else bg
    diff = frames.astype(np.int16) - bg.astype(np.int16)
    return np.clip(diff + 127, 0, 255).astype(np.uint8)


class ArrayDataset:
    """Dict-of-arrays dataset with aligned first axis."""

    def __init__(self, arrays: dict, transform: Optional[Callable] = None):
        lengths = {k: len(v) for k, v in arrays.items()}
        assert len(set(lengths.values())) == 1, f"misaligned arrays: {lengths}"
        self.arrays = arrays
        self.transform = transform

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, idx) -> dict:
        item = {k: v[idx] for k, v in self.arrays.items()}
        return self.transform(item) if self.transform else item


class VisionTactileDataset:
    """Frame-window dataset (reference vision_tactile.py:29-166).

    frames: (T, H, W, C) uint8; labels: optional dict of (T, ...) arrays
    aligned to the LAST frame of each window.
    """

    def __init__(
        self,
        frames: np.ndarray,
        *,
        num_frames: int = 2,
        frame_stride: int = 1,
        out_format: str = "concat_ch_img",  # or "single_image" / "video"
        labels: Optional[dict] = None,
        transform: Optional[Callable] = None,
        remove_background: bool = False,
    ):
        assert out_format in ("concat_ch_img", "single_image", "video")
        if remove_background:
            frames = background_difference(frames)
        self.frames = frames
        self.num_frames = num_frames
        self.frame_stride = frame_stride
        self.out_format = out_format
        self.labels = labels or {}
        self.transform = transform
        self.span = (num_frames - 1) * frame_stride

    def __len__(self) -> int:
        return max(len(self.frames) - self.span, 0)

    def __getitem__(self, idx) -> dict:
        sel = [idx + i * self.frame_stride for i in range(self.num_frames)]
        window = self.frames[sel]  # (T, H, W, C)
        if self.out_format == "single_image":
            img = window[-1]
        elif self.out_format == "concat_ch_img":
            t, h, w, c = window.shape
            img = window.transpose(1, 2, 0, 3).reshape(h, w, t * c)
        else:  # video: the uint8 clip as it is, a quarter of the f32 clip's bytes to stack and copy
            img = window
        item = {"image": img.astype(np.float32) / 255.0 if img.dtype == np.uint8 and self.out_format != "video" else img}
        anchor = sel[-1]
        for k, v in self.labels.items():
            item[k] = v[anchor]
        return self.transform(item) if self.transform else item


class DataLoader:
    """Epoch-shuffled minibatch iterator yielding stacked dict batches; each batch's assembly is
    span ``data.batch`` (``utils/trace.py``)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True, drop_last: bool = True, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        end = n - (n % self.batch_size) if self.drop_last else n
        for start in range(0, end, self.batch_size):
            with trace.span("data.batch"):  # the batch's assembly, closed before the caller resumes
                idx = order[start : start + self.batch_size]
                items = [self.dataset[int(i)] for i in idx]
                batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
            yield batch


# ---------------------------------------------------------------------- #
# augmentations (reference vision_tactile.py:112-155)
# ---------------------------------------------------------------------- #
def random_flip(item: dict, rng: np.random.Generator, p: float = 0.5) -> dict:
    if rng.random() < p:
        item = dict(item)
        item["image"] = np.ascontiguousarray(item["image"][..., :, ::-1, :])
    return item


def random_crop_resize(item: dict, rng: np.random.Generator, scale=(0.8, 1.0)) -> dict:
    import cv2

    img = item["image"]
    h, w = img.shape[-3], img.shape[-2]
    s = rng.uniform(*scale)
    ch, cw = int(h * s), int(w * s)
    top = rng.integers(0, h - ch + 1)
    left = rng.integers(0, w - cw + 1)
    crop = img[..., top : top + ch, left : left + cw, :]
    out = cv2.resize(crop, (w, h), interpolation=cv2.INTER_LINEAR)
    item = dict(item)
    item["image"] = out.reshape(img.shape)
    return item
