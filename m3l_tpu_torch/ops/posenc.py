"""Sinusoidal positional tables (counterpart of ``m3l_tpu/ops/posenc.py``).

* :func:`sincos_2d`: the layout of ``positional_encodings.PositionalEncoding2D``, an x-block then
  a y-block, sin/cos interleaved within each (the VTT models).
* :func:`sincos_nd`: the DINOv2-style n-D table with ``10000**-linspace`` bands (the ViT zoo and
  the SSL decoders).

Each table is a pure function of its shape, computed once in float64 with numpy and returned as
float32; models keep it as a buffer.
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


def sincos_nd(grid_shape: tuple[int, ...], dim: int, temperature: float = 10000.0) -> np.ndarray:
    """(prod(grid), dim) float32 table over an n-D grid, rows flattened row-major.

    Each of the n axes gets a block of ``dim // n`` channels rounded down to even (the remainder
    stays zero at the end): sin of the position times ``temperature ** -linspace(0, 1, block//2)``
    in its first half, cos in its second."""
    n_axes = len(grid_shape)
    block = (dim // n_axes) // 2 * 2
    if block < 2:
        raise ValueError(f"dim {dim} too small for {n_axes} axes")
    half = block // 2
    freqs = temperature ** (-np.linspace(0.0, 1.0, half, dtype=np.float64))
    mesh = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in grid_shape], indexing="ij")
    out = np.zeros((int(np.prod(grid_shape)), dim), dtype=np.float64)
    for ax, pos in enumerate(mesh):
        ang = pos.reshape(-1)[:, None] * freqs[None, :]
        out[:, ax * block : ax * block + half] = np.sin(ang)
        out[:, ax * block + half : (ax + 1) * block] = np.cos(ang)
    return out.astype(np.float32)
