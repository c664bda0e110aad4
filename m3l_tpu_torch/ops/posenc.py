"""2-D sinusoidal positional table (counterpart of ``m3l_tpu/ops/posenc.py`` ``sincos_2d``).

Layout of ``positional_encodings.PositionalEncoding2D``: an x-block then a y-block, sin/cos
interleaved within each. The table is a pure function of (height, width, channels), computed
once in float64 with numpy and returned as float32; models keep it as a buffer.
"""
from __future__ import annotations

import numpy as np


def _interleaved_sincos(pos: np.ndarray, inv_freq: np.ndarray) -> np.ndarray:
    """stack(sin, cos) interleaved over the last axis: (P, 2*F)."""
    ang = np.einsum("i,j->ij", pos, inv_freq)
    return np.stack([np.sin(ang), np.cos(ang)], axis=-1).reshape(ang.shape[0], -1)


def sincos_2d(height: int, width: int, channels: int) -> np.ndarray:
    """(height*width, channels) float32 table; rows flattened row-major (row*width + col).

    ``ch = ceil(channels/4)*2`` sub-channels per axis with ``inv_freq = 1/10000**(arange(0, ch, 2)/ch)``:
    the first ``ch`` channels embed the row, the next ``ch`` the column; truncated to ``channels``."""
    ch = int(np.ceil(channels / 4) * 2)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, ch, 2, dtype=np.float64) / ch))
    emb_x = _interleaved_sincos(np.arange(height, dtype=np.float64), inv_freq)  # (H, ch)
    emb_y = _interleaved_sincos(np.arange(width, dtype=np.float64), inv_freq)  # (W, ch)
    out = np.zeros((height, width, 2 * ch), dtype=np.float64)
    out[:, :, :ch] = emb_x[:, None, :]
    out[:, :, ch : 2 * ch] = emb_y[None, :, :]
    return out[:, :, :channels].reshape(height * width, channels).astype(np.float32)
