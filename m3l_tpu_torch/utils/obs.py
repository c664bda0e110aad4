"""Observation -> model input packing (counterpart of ``m3l_tpu/utils/obs.py``).

``vt_load`` turns raw environment observations into the NHWC float inputs of the models:

* ``image``: (..., H, W, 3*fs) in [0, 1], frame-major RGB triplets [f0·rgb, f1·rgb, ...];
  uint8 images are dequantized here, on whatever device the tensor lies on.
* ``tactile``: the env's interleaved channel-first stack (B, fs*C, H, W), C = 3 * sensors
  per frame, de-interleaved per sensor into ``tactile1..N`` of shape (..., H, W, 3*fs) with the
  same frame-major order, then mapped from [-1, 1] to [0, 1].

The 5-D FrameStack layouts are unfolded first: image (B, fs, H, W, 3) -> (B, H, W, fs*3) and
tactile (B, fs, C, H, W) -> (B, fs*C, H, W).
"""
from __future__ import annotations

import torch


def vt_load(x: dict, frame_stack: int = 1) -> dict:
    out: dict = {}
    if "image" in x:
        img = torch.as_tensor(x["image"])
        if img.dim() == 3:
            img = img[None]
        if img.dim() == 5:  # (B, fs, H, W, 3) -> (B, H, W, fs*3)
            b, fs, h, w, c = img.shape
            img = img.permute(0, 2, 3, 1, 4).reshape(b, h, w, fs * c)
        if img.shape[-1] != 3 * frame_stack:
            raise ValueError(f"image channels {img.shape[-1]} != 3*frame_stack ({3 * frame_stack})")
        if img.dtype == torch.uint8:
            img = img.to(torch.float32) / 255.0
        out["image"] = img.to(torch.float32)  # the reference's image normalization (0, 1) is the identity

    if "tactile" in x:
        tac = torch.as_tensor(x["tactile"])
        if tac.dim() == 3:
            tac = tac[None]
        if tac.dim() == 5:  # (B, fs, C, H, W) -> (B, fs*C, H, W)
            b, fs, c, h, w = tac.shape
            tac = tac.reshape(b, fs * c, h, w)
        per_frame = tac.shape[1] // frame_stack
        if per_frame * frame_stack != tac.shape[1] or per_frame % 3:
            raise ValueError(
                f"tactile channels {tac.shape[1]} not divisible into 3-channel sensors x frame_stack {frame_stack}"
            )
        # de-interleave: sensor k, frame f lives at channels f*per_frame + 3k + {0,1,2}
        base = (torch.arange(frame_stack)[:, None] * per_frame + torch.arange(3)[None, :]).reshape(-1).to(tac.device)
        for k in range(per_frame // 3):
            sel = tac.index_select(1, base + 3 * k).permute(0, 2, 3, 1)  # (B, H, W, 3*fs)
            out[f"tactile{k + 1}"] = _unit_range(sel)

    for key in x:
        if key.startswith("tactile") and key != "tactile":
            out[key] = _unit_range(torch.as_tensor(x[key]))
    return out


def _unit_range(t: torch.Tensor) -> torch.Tensor:
    """Tactile [-1, 1] -> [0, 1], as (t - (-1)) / (1 - (-1)) in f32."""
    return (t.to(torch.float32) + 1.0) / 2.0
