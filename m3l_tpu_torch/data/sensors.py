"""Sensor-specific dataset loaders (DIGIT / GelSight): the port's own numpy copy of
``m3l_tpu/data/sensors.py``.

* DIGIT conventions: binary-buffer decode, background difference with a +0.5 offset, portrait
  rotation, 4:3 center crop, brightness/contrast enhancement, per-object background ids
  (reference tactile_ssl/data/digit/utils.py:15-223);
* ``DigitYCBSlideDataset``: image-directory pairs ``d_frames`` apart with consistent
  flip/crop/rotation augmentations (digit_ycbslide.py:28-136);
* ``GelsightGraspDataset``: the "feeling of success" before/during/after frames with the
  is_gripping label (gelsight_grasp.py:22-110);
* ``VisionForceSlipDataset``: per-trajectory force and slip labels with horizon debouncing and
  abs/delta force normalisation (vision_based_forces_slip_probes.py:31-219);
* ``DigitSlipDataset`` (digit_slip.py:26-96) and ``ForceFieldSSLDataset``
  (vision_tactile_forcefield.py:29-138).

Host-side numpy, as the rest of ``data/``: images HWC uint8 or float32, frames concatenated on the
last axis; the DataLoader batches and the Trainer moves batches to the device. cv2 and PIL are
imported where they are used.
"""
from __future__ import annotations

import io
import os
import pickle
from glob import glob
from typing import Optional, Sequence

import numpy as np

SLIP_LABELS = {0: "no_slip", 1: "slip"}

# per-object background ids for the DIGIT YCB datasets
# (reference digit/utils.py:15-35)
DIGIT_BGS_OBJECTS = {
    "004_sugar_box": 0,
    "005_tomato_soup_can": 1,
    "006_mustard_bottle": 2,
    "021_bleach_cleanser": 3,
    "025_mug": 4,
    "035_power_drill": 0,
    "037_scissors": 5,
    "042_adjustable_wrench": 6,
    "048_hammer": 8,
    "055_baseball": 8,
    "banana": 15,
    "bread": 11,
    "cheese": 16,
    "cookie": 17,
    "corn": 18,
    "lettuce": 17,
    "plum": 11,
    "strawberry": 17,
    "tomato": 16,
}


# ---------------------------------------------------------------------- #
# image conventions (digit/utils.py:51-170)
# ---------------------------------------------------------------------- #
def compute_diff(img1: np.ndarray, img2: np.ndarray, offset: float = 0.0) -> np.ndarray:
    """Signed background difference shifted by ``offset`` (utils.py:51-58)."""
    diff = img1.astype(np.int32) - img2.astype(np.int32)
    diff = diff / 255.0 + offset
    return np.uint8(np.clip(diff, 0.0, 1.0) * 255.0)


def load_bin_image(buf) -> np.ndarray:
    """Decode a compressed image buffer to an RGB array (utils.py:113-116)."""
    import PIL.Image

    img = PIL.Image.open(io.BytesIO(buf))
    return np.array(img.convert("RGB"))


def enhance_image(img: np.ndarray, brightness: int = 255, contrast: int = 127) -> np.ndarray:
    """Brightness/contrast enhancement for gelsight_mini diff images
    (utils.py:148-170)."""
    import cv2

    brightness = int((brightness - 0) * (255 - (-255)) / (510 - 0) + (-255))
    contrast = int((contrast - 0) * (127 - (-127)) / (254 - 0) + (-127))
    cal = img
    if brightness != 0:
        if brightness > 0:
            shadow, peak = brightness, 255
        else:
            shadow, peak = 0, 255 + brightness
        alpha = (peak - shadow) / 255
        cal = cv2.addWeighted(img, alpha, img, 0, shadow)
    if contrast != 0:
        alpha = float(131 * (contrast + 127)) / (127 * (131 - contrast))
        cal = cv2.addWeighted(cal, alpha, cal, 0, 127 * (1 - alpha))
    return cal


def load_sample_from_buf(buf, img_bg: Optional[np.ndarray] = None, enhance: bool = False) -> np.ndarray:
    """DIGIT/GelSight frame decode with the reference conventions
    (utils.py:125-146): optional bg-diff, rotate landscape frames to
    portrait, center-crop to the 4:3 aspect. Returns HWC uint8 RGB."""
    import cv2

    img = load_bin_image(buf) if isinstance(buf, (bytes, bytearray)) else np.asarray(buf)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected HWC RGB, got {img.shape}")
    if img_bg is not None:
        img = compute_diff(img, img_bg, offset=0.5)
    h, w, _ = img.shape
    if h < w:
        if enhance:
            img = enhance_image(img, brightness=280, contrast=200)
        img = cv2.rotate(img, cv2.ROTATE_90_CLOCKWISE)
        h, w, _ = img.shape
    r = 4 / 3
    if h / w != r:
        h2 = int(h / r)
        img = img[(h - h2) // 2 : (h + h2) // 2]
    return img


def resize_image(img: np.ndarray, img_sz: Sequence[int]) -> np.ndarray:
    """Resize to (H, W) and scale to float32 [0, 1] HWC — the reference's
    Resize+ToTensor transform (utils.py:79-87), channels-last here."""
    import cv2

    out = cv2.resize(img, (int(img_sz[1]), int(img_sz[0])), interpolation=cv2.INTER_AREA)
    return out.astype(np.float32) / 255.0


def get_bg_img(path_bgs: str, sensor_type: str, dataset_name: str, remove_bg: bool = True) -> Optional[np.ndarray]:
    """Per-object (DIGIT) or shared (gelsight_mini) background frame
    (utils.py:90-103)."""
    if not remove_bg:
        return None
    import cv2

    if sensor_type == "digit":
        bg_id = DIGIT_BGS_OBJECTS[dataset_name.split("/")[0]]
        bg = cv2.imread(os.path.join(path_bgs, f"bg_{bg_id}.jpg"))
    elif sensor_type == "gelsight_mini":
        bg = cv2.imread(os.path.join(path_bgs, "bg_gs.jpg"))
    else:
        raise ValueError(f"Unknown sensor type {sensor_type!r}")
    return cv2.cvtColor(bg, cv2.COLOR_BGR2RGB)


# ---------------------------------------------------------------------- #
# pickled-dataset loaders (digit/utils.py:107-223)
# ---------------------------------------------------------------------- #
def load_dataset_forces(path_dataset: str, dataset_name: str, sensor: str):
    """Force/slip dataset: sharded image pickles + label pickle
    (utils.py:173-188)."""
    path_data = os.path.join(path_dataset, dataset_name)
    frames = []
    for p in sorted(glob(os.path.join(path_data, f"dataset_{sensor}*"))):
        with open(p, "rb") as f:
            frames.extend(pickle.load(f))
    with open(os.path.join(path_data, "dataset_slip_forces.pkl"), "rb") as f:
        force_slip = pickle.load(f)
    return frames, force_slip


def load_feeling_success(path_dataset: str, dataset_name) -> dict:
    """"Feeling of success" grasp pickle (utils.py:191-196)."""
    name = f"{dataset_name:03d}.pkl" if isinstance(dataset_name, int) else f"{dataset_name}.pkl"
    with open(os.path.join(path_dataset, name), "rb") as f:
        return pickle.load(f)


def load_dataset_poses(path_dataset: str, dataset_name: str, finger_type: str, t_stride: int):
    """Pose-estimation pickle: aligned digit frames + relative poses
    (utils.py:199-215)."""
    with open(os.path.join(path_dataset, f"{dataset_name}.pkl"), "rb") as f:
        data = pickle.load(f)
    frames = data[f"digit_{finger_type}"]
    poses = data[f"object_{finger_type}_rel_pose_n{t_stride}"]
    idx_max = min(len(frames), len(poses))
    return frames[:idx_max], poses[:idx_max]


def load_textile_dataset(path_dataset: str, dataset_name: str):
    """Textile pickle + metadata text (utils.py:218-223)."""
    with open(os.path.join(path_dataset, dataset_name, "dataset_gelsight.pkl"), "rb") as f:
        data = pickle.load(f)
    meta_path = os.path.join(path_dataset, dataset_name, "metadata.txt")
    metadata = ""
    if os.path.isfile(meta_path):
        with open(meta_path) as f:
            metadata = f.read()
    return data, metadata


# ---------------------------------------------------------------------- #
# augmentations (digit_ycbslide.py:88-133 / vision_tactile.py:112-155)
# ---------------------------------------------------------------------- #
def _augment_window(images: list[np.ndarray], img_sz, rng: np.random.Generator, p_flip: float, p_crop: float, p_rot: float) -> list[np.ndarray]:
    """Consistent flip/crop/rotation across a frame window (the reference
    draws the aug params once per sample, digit_ycbslide.py:88-133)."""
    import cv2

    do_flip = rng.random() < p_flip
    do_crop = rng.random() < p_crop
    do_rot = rng.random() < p_rot
    h = int(img_sz[0])
    if do_crop:
        crop_size = int(rng.uniform(0.6, 0.9) * h)
        max_off = h - crop_size
        left = int(rng.random() * max_off)
        top = int(rng.random() * max_off)
    if do_rot:
        angle = rng.random() * 20 - 10
        # valid central square after rotation (reference computes it from a
        # rotated ones-mask; the closed form for small angles)
        rad = abs(np.deg2rad(angle))
        margin = int(np.ceil(h * np.sin(rad) / (np.sin(rad) + np.cos(rad))))
        rot_size = max(h - 2 * margin, 1)

    out = []
    for img in images:
        if do_flip:
            img = img[:, ::-1]
        if do_crop:
            img = img[top : top + crop_size, left : left + crop_size]
            img = cv2.resize(img, (int(img_sz[1]), int(img_sz[0])), interpolation=cv2.INTER_LINEAR)
        if do_rot:
            m = cv2.getRotationMatrix2D((img.shape[1] / 2, img.shape[0] / 2), angle, 1.0)
            img = cv2.warpAffine(img, m, (img.shape[1], img.shape[0]), flags=cv2.INTER_LINEAR)
            img = img[margin : margin + rot_size, margin : margin + rot_size]
            img = cv2.resize(img, (int(img_sz[1]), int(img_sz[0])), interpolation=cv2.INTER_LINEAR)
        out.append(np.ascontiguousarray(img))
    return out


# ---------------------------------------------------------------------- #
# datasets
# ---------------------------------------------------------------------- #
class DigitYCBSlideDataset:
    """DIGIT YCB-Slide image-directory dataset (digit_ycbslide.py:28-136):
    each item is the channel-concat of the frame at ``idx`` and the frame
    ``d_frames`` earlier, with optional background diff and consistent
    flip/crop/rot augmentations."""

    def __init__(
        self,
        path_images: Sequence[str] | str,
        *,
        d_frames: int = 1,
        img_sz: Sequence[int] = (224, 224),
        bg: Optional[np.ndarray] = None,
        p_flip: float = 0.0,
        p_crop: float = 0.0,
        p_rot: float = 0.0,
        seed: int = 0,
    ):
        if isinstance(path_images, str):
            path_images = sorted(
                p for p in glob(os.path.join(path_images, "*")) if p.lower().endswith((".jpg", ".jpeg", ".png"))
            )
        self.path_images = list(path_images)
        self.d_frames = d_frames
        self.frames_concat_idx = [0, -d_frames]
        self.img_sz = tuple(img_sz)
        self.bg = bg
        self.p_flip, self.p_crop, self.p_rot = p_flip, p_crop, p_rot
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return max(len(self.path_images) - 2 * self.d_frames, 0)

    def _load(self, path: str) -> np.ndarray:
        import cv2

        img = cv2.imread(path)
        if self.bg is not None:
            img = compute_diff(img, self.bg, offset=0.5)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def __getitem__(self, idx: int) -> dict:
        idx += self.d_frames
        images = [resize_image(self._load(self.path_images[idx + i]), self.img_sz) for i in self.frames_concat_idx]
        images = _augment_window(images, self.img_sz, self._rng, self.p_flip, self.p_crop, self.p_rot)
        return {"image": np.concatenate(images, axis=-1)}


class GelsightGraspDataset:
    """"Feeling of success" grasp dataset (gelsight_grasp.py:22-110):
    randomly picks sensor A/B and a (during, before) or (after, during) frame
    pair; label = is_gripping."""

    def __init__(
        self,
        dataset: dict,
        *,
        out_format: str = "concat_ch_img",
        num_frames: int = 2,
        img_sz: Sequence[int] = (224, 224),
        seed: int = 0,
    ):
        if out_format not in ("video", "concat_ch_img", "single_image"):
            raise ValueError(f"unknown out_format {out_format!r}")
        self.dataset = dataset
        self.out_format = out_format
        self.num_frames = 1 if out_format == "single_image" else num_frames
        self.img_sz = tuple(img_sz)
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset["is_gripping"])

    def _frame(self, key: str, idx: int) -> np.ndarray:
        return resize_image(load_sample_from_buf(self.dataset[key][idx]), self.img_sz)

    def __getitem__(self, idx: int) -> dict:
        sensor = "gelsightA" if self._rng.random() >= 0.5 else "gelsightB"
        if self.out_format == "single_image":
            image = self._frame(f"{sensor}_during", idx)
        elif self.out_format == "concat_ch_img":
            if self._rng.random() >= 0.5:
                pair = (f"{sensor}_during", f"{sensor}_before")
            else:
                pair = (f"{sensor}_after", f"{sensor}_during")
            image = np.concatenate([self._frame(k, idx) for k in pair], axis=-1)
        else:  # video: after, during, before, before (gelsight_grasp.py:92-107)
            if self.num_frames != 4:
                raise ValueError("video format supports 4 frames only")
            keys = [f"{sensor}_after", f"{sensor}_during", f"{sensor}_before", f"{sensor}_before"]
            image = np.stack([self._frame(k, idx) for k in keys], axis=0)
        return {"image": image, "grasp_label": int(self.dataset["is_gripping"][idx])}


class VisionForceSlipDataset:
    """Joint force + slip probe dataset
    (vision_based_forces_slip_probes.py:31-219): per-trajectory frame
    windows, slip labels debounced over ``slip_horizon`` (any slip in the
    window -> slip), absolute and delta forces normalized by their max
    scales and clipped to [-1, 1]."""

    def __init__(
        self,
        frames: Sequence,
        trajectories: dict,
        *,
        in_contact: Optional[np.ndarray] = None,
        slip_horizon: int = 3,
        num_frames: int = 2,
        frame_stride: int = 1,
        out_format: str = "concat_ch_img",
        img_sz: Sequence[int] = (224, 224),
        max_abs_force: Sequence[float] = (1.0, 1.0, 1.0),
        max_delta_force: Sequence[float] = (1.0, 1.0, 1.0),
        remove_bg: bool = False,
    ):
        if out_format not in ("video", "concat_ch_img", "single_image"):
            raise ValueError(f"unknown out_format {out_format!r}")
        self.frames = frames
        self.trajectories = trajectories
        self.slip_horizon = slip_horizon
        self.out_format = out_format
        self.num_frames = 1 if out_format == "single_image" else num_frames
        self.frames_concat_idx = np.arange(0, self.num_frames * frame_stride, frame_stride)
        self.img_sz = tuple(img_sz)
        self.max_abs_force = np.asarray(max_abs_force, np.float32)
        self.max_delta_force = np.asarray(max_delta_force, np.float32)
        self.bg = None
        if remove_bg and in_contact is not None:
            idx_bg = int(np.where(np.asarray(in_contact) == 0)[0][0])
            self.bg = load_bin_image(frames[idx_bg]) if isinstance(frames[idx_bg], (bytes, bytearray)) else np.asarray(frames[idx_bg])
        self.idx2traj, self.traj2idx, self.slip_labels = self._map_idx2traj()

    # the first 5 samples of each trajectory are skipped (settling frames,
    # vision_based_forces_slip_probes.py:94)
    def _map_idx2traj(self):
        idx2traj, traj2idx, slip_all = {}, {}, []
        idx = -1
        for traj in self.trajectories:
            traj2idx[traj] = []
            t_idxs = self.trajectories[traj]["indexes"][5:]
            for sample in range(len(t_idxs)):
                idx += 1
                traj2idx[traj].append(idx)
                horizon = self._slip_horizon_labels(traj, sample)
                idx2traj[idx] = {"trajectory": traj, "sample": sample, "slip_horizon_labels": horizon}
                slip_all.append(0 if horizon.sum() == 0 else 1)
        return idx2traj, traj2idx, np.asarray(slip_all)

    def _slip_horizon_labels(self, traj, sample) -> np.ndarray:
        slip = np.asarray(self.trajectories[traj]["slip_label"])
        t = np.clip(sample + np.arange(0, self.slip_horizon + 1), 0, len(slip) - 1)
        return slip[t].astype(int)

    def __len__(self) -> int:
        return len(self.idx2traj)

    def __getitem__(self, idx: int) -> dict:
        info = self.idx2traj[idx]
        traj, sample = info["trajectory"], info["sample"]
        label = 0 if info["slip_horizon_labels"].sum() == 0 else 1

        forces = np.asarray(self.trajectories[traj]["forces"], np.float32)
        n = len(self.trajectories[traj]["indexes"])
        prev = int(np.clip(sample - self.frames_concat_idx[-1], 0, n - 1))
        delta = np.clip((forces[sample] - forces[prev]) / self.max_delta_force, -1.0, 1.0)
        abs_f = np.clip(forces[sample] / self.max_abs_force, -1.0, 1.0)

        return {
            "image": self._window(traj, sample),
            "force": abs_f.astype(np.float32),
            "delta_force": delta.astype(np.float32),
            "slip_label": label,
            "slip_category_label": SLIP_LABELS[label],
            "force_scale": self.max_abs_force,
            "delta_force_scale": self.max_delta_force,
        }

    def _window(self, traj, sample) -> np.ndarray:
        t_indexes = self.trajectories[traj]["indexes"]
        n = len(t_indexes)
        images = []
        s = sample
        for i in self.frames_concat_idx:
            s = int(np.clip(sample - i, 0, n - 1))
            images.append(resize_image(load_sample_from_buf(self.frames[t_indexes[s]], self.bg), self.img_sz))
        if self.out_format == "single_image":
            return images[0]
        if self.out_format == "video":
            return np.stack(images, axis=0)
        return np.concatenate(images, axis=-1)


DIGIT_SLIP_LABELS = {0: "no_contact", 1: "no_shear", 2: "shear", 3: "partial_slip", 4: "slip"}


class DigitSlipDataset:
    """Five-class DIGIT slip dataset over an image directory
    (reference tactile_ssl/data/digit_slip.py:26-96): each item is the
    channel-concat of the frame at ``idx`` and the frame ``d_frames``
    earlier, labeled with {no_contact, no_shear, shear, partial_slip, slip}.
    ``with_markers`` sensors disable background diff and use a single frame
    plus the sequence's first frame as the static reference
    (digit_slip.py:47-50, 90-94)."""

    def __init__(
        self,
        path_images: Sequence[str] | str,
        labels_slip: Sequence[int],
        *,
        d_frames: int = 1,
        img_sz: Sequence[int] = (224, 224),
        remove_bg: bool = True,
        with_markers: bool = False,
    ):
        if isinstance(path_images, str):
            path_images = sorted(
                p for p in glob(os.path.join(path_images, "*")) if p.lower().endswith((".jpg", ".jpeg", ".png"))
            )
        self.path_images = list(path_images)
        self.gt_slip = np.asarray(labels_slip)
        self.d_frames = d_frames
        self.img_sz = tuple(img_sz)
        self.with_markers = with_markers
        if with_markers:  # markers carry the shear signal; keep them intact
            remove_bg = False
            self.frames_concat_idx = [0]
        else:
            self.frames_concat_idx = [0, -d_frames]
        self.bg = self._imread(self.path_images[0]) if remove_bg else None

    @staticmethod
    def _imread(path: str) -> np.ndarray:
        import cv2

        return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)

    def __len__(self) -> int:
        return max(len(self.path_images) - 2 * self.d_frames, 0)

    def _load(self, path: str) -> np.ndarray:
        img = self._imread(path)
        if self.bg is not None:
            img = compute_diff(img, self.bg, offset=0.5)
        return resize_image(img, self.img_sz)

    def __getitem__(self, idx: int) -> dict:
        idx += self.d_frames
        images = [self._load(self.path_images[idx + i]) for i in self.frames_concat_idx]
        if self.with_markers:
            images.append(self._load(self.path_images[0]))
        label = int(self.gt_slip[idx])
        return {
            "image": np.concatenate(images, axis=-1),
            "label": label,
            "category_label": DIGIT_SLIP_LABELS[label],
        }


class ForceFieldSSLDataset:
    """Force-field SSL dataset (reference
    tactile_ssl/data/vision_tactile_forcefield.py:29-138): a frame window
    (video / concat_ch_img / single_image, stride ``frame_stride``) plus —
    in concat mode — ``image_bg``: the current frame channel-concatenated
    with the sensor background, which the geometric SSL objective warps
    against (forcefield_sl.py:95-412; tasks/forcefield_geometry.py here)."""

    def __init__(
        self,
        frames: Sequence,
        *,
        bg: Optional[np.ndarray] = None,
        num_frames: int = 2,
        frame_stride: int = 1,
        out_format: str = "concat_ch_img",
        img_sz: Sequence[int] = (224, 224),
    ):
        if out_format not in ("video", "concat_ch_img", "single_image"):
            raise ValueError(f"unknown out_format {out_format!r}")
        self.frames = frames
        self.bg = bg
        self.out_format = out_format
        self.num_frames = 1 if out_format == "single_image" else num_frames
        self.frames_concat_idx = np.arange(0, self.num_frames * frame_stride, frame_stride)
        self.img_sz = tuple(img_sz)

    def __len__(self) -> int:
        return len(self.frames)

    def _frame(self, idx: int) -> np.ndarray:
        return resize_image(load_sample_from_buf(self.frames[idx], self.bg), self.img_sz)

    def __getitem__(self, idx: int) -> dict:
        idx += int(self.frames_concat_idx[-1])
        images = [self._frame(int(np.clip(idx - i, 0, len(self.frames) - 1))) for i in self.frames_concat_idx]
        item = {}
        if self.out_format == "single_image":
            item["image"] = images[0]
        elif self.out_format == "video":
            item["image"] = np.stack(images, axis=0)
        else:
            item["image"] = np.concatenate(images, axis=-1)
            if self.bg is not None:
                bg = resize_image(load_sample_from_buf(self.bg, self.bg), self.img_sz)
                item["image_bg"] = np.concatenate([images[0], bg], axis=-1)
        return item
