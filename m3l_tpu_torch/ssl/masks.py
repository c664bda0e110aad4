"""Vectorized, static-shape mask samplers (counterpart of ``m3l_tpu/ssl/masks.py``).

Masks are boolean (M, B, N) keep-arrays under the JAX package's distribution family:

* block area ~ U(scale_min, scale_max), one block size per call, shared across the batch;
* block top-left corners uniform per (mask, sample);
* global masks optionally constrained to the complement of the local masks, falling back to the
  unconstrained block for a sample whose constrained block keeps ``min_keep`` patches or fewer;
* tube masks: a spatial keep-set of static size extruded through time.

Every draw comes from a ``torch.Generator`` on the target device. The samplers draw their
uniforms and hand them to helpers that take the uniforms as tensors (``block_masks_from_uniforms``,
``tube_masks_from_noise``), so a test can feed in the uniforms JAX drew and require equal masks.
Consumers run the encoder at full length with attention key-masking.
"""
from __future__ import annotations

from typing import Optional

import torch


def _block_mask(top: torch.Tensor, left: torch.Tensor, h: torch.Tensor, w: torch.Tensor, grid_h: int, grid_w: int) -> torch.Tensor:
    """(..., grid_h*grid_w) bool block mask from corner and size tensors."""
    rows = torch.arange(grid_h, device=top.device)
    cols = torch.arange(grid_w, device=top.device)
    rmask = (rows >= top[..., None]) & (rows < (top + h)[..., None])
    cmask = (cols >= left[..., None]) & (cols < (left + w)[..., None])
    return (rmask[..., :, None] & cmask[..., None, :]).reshape(*top.shape, grid_h * grid_w)


def _sample_size(u: torch.Tensor, grid_h: int, grid_w: int, scale: tuple[float, float]) -> tuple[torch.Tensor, torch.Tensor]:
    """One (h, w) per call from the scalar uniform ``u``, in f32 as JAX computes it."""
    u = u.to(torch.float32)
    area = scale[0] + u * (scale[1] - scale[0])
    max_keep = grid_h * grid_w * area
    side = torch.round(torch.sqrt(max_keep)).to(torch.int32)  # round half to even, as jnp.round
    return side.clamp(1, grid_h), side.clamp(1, grid_w)


def block_masks_from_uniforms(
    u_size: torch.Tensor, u_top: torch.Tensor, u_left: torch.Tensor, grid_hw: tuple[int, int], scale: tuple[float, float]
) -> torch.Tensor:
    """(M, B, grid_h*grid_w) bool keep-masks from a scalar size uniform and (M, B) corner uniforms."""
    gh, gw = grid_hw
    h, w = _sample_size(u_size, gh, gw, scale)
    top = torch.floor(u_top.float() * (gh - h + 1).float()).to(torch.int32)
    left = torch.floor(u_left.float() * (gw - w + 1).float()).to(torch.int32)
    return _block_mask(top, left, h, w, gh, gw)


def _device(generator: Optional[torch.Generator], device):
    """``device``, else the generator's (the CPU without either)."""
    if device is not None:
        return device
    return generator.device if generator is not None else "cpu"


def sample_block_masks(
    generator: Optional[torch.Generator], batch: int, grid_hw: tuple[int, int], scale: tuple[float, float], n_masks: int, device=None
) -> torch.Tensor:
    """(n_masks, batch, grid_h*grid_w) bool keep-masks drawn from ``generator`` on ``device``
    (the generator's device when not given)."""
    device = _device(generator, device)
    u_size = torch.rand((), generator=generator, device=device)
    u_top = torch.rand((n_masks, batch), generator=generator, device=device)
    u_left = torch.rand((n_masks, batch), generator=generator, device=device)
    return block_masks_from_uniforms(u_size, u_top, u_left, grid_hw, scale)


def constrain(raw: torch.Tensor, forbidden: torch.Tensor, min_keep: int) -> torch.Tensor:
    """``raw`` (M, B, N) masks minus ``forbidden`` (B, N) where more than ``min_keep`` patches
    remain; else the raw block for that (mask, sample)."""
    constrained = raw & ~forbidden[None]
    ok = constrained.sum(-1) > min_keep
    return torch.where(ok[..., None], constrained, raw)


def sample_block_masks_constrained(
    generator: Optional[torch.Generator],
    batch: int,
    grid_hw: tuple[int, int],
    scale: tuple[float, float],
    n_masks: int,
    forbidden: torch.Tensor,
    min_keep: int,
) -> torch.Tensor:
    """Global masks constrained away from ``forbidden`` (B, N) bool, True where a mask may NOT keep
    (the union of the local masks), drawn on ``forbidden``'s device."""
    raw = sample_block_masks(generator, batch, grid_hw, scale, n_masks, device=forbidden.device)
    return constrain(raw, forbidden, min_keep)


def tube_masks_from_noise(noise: torch.Tensor, frames: int, ratio: float) -> torch.Tensor:
    """(M, B, T*H*W) bool keep-masks from spatial noise (M, B, H*W): the round(H*W*(1-ratio))
    patches (at least one) of smallest noise in each frame, the same in every frame."""
    n_spatial = noise.shape[-1]
    keep = max(int(round(n_spatial * (1.0 - ratio))), 1)
    ranks = torch.argsort(torch.argsort(noise, dim=-1, stable=True), dim=-1, stable=True)
    return (ranks < keep).repeat(1, 1, frames)


def random_tube_masks(
    generator: Optional[torch.Generator], batch: int, grid_thw: tuple[int, int, int], ratio: float, n_masks: int, device=None
) -> torch.Tensor:
    """V-JEPA-style tube masks (n_masks, batch, T*H*W) bool with a static keep count per frame."""
    t, h, w = grid_thw
    noise = torch.rand((n_masks, batch, h * w), generator=generator, device=_device(generator, device))
    return tube_masks_from_noise(noise, t, ratio)
